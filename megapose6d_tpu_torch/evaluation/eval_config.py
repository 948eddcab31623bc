"""Evaluation configuration, its save directory and `key=value` overrides.

Counterpart of `EvalConfig`, `get_save_dir` and `apply_eval_overrides` in
`megapose6d_tpu/evaluation/eval_config.py`, with the fields the port
reads. The port adds `coarse_weights` / `refiner_weights` (npz files of
the runs' params, see `inference/load_model.py`; empty: weights drawn from
a fixed seed), `data_dir` (the root holding `<ds_name>/`; empty:
`MEGAPOSE_DATA_DIR/bop_datasets`) and `device`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

from ..inference.types import InferenceConfig


@dataclasses.dataclass
class EvalConfig:
    """One (dataset, detection type, coarse type) evaluation."""

    # Networks: run directories (their config.json) and weight files.
    coarse_run: str = ""
    refiner_run: str = ""
    coarse_weights: str = ""
    refiner_weights: str = ""

    # Dataset.
    ds_name: str = "ycbv.bop19"
    data_dir: str = ""

    inference: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)

    # Run management.
    save_dir: Optional[str] = None
    n_frames: Optional[int] = None
    skip_inference: bool = False
    skip_evaluation: bool = False

    # Models built without a run directory, and the mesh database.
    render_size: tuple[int, int] = (240, 320)
    max_faces: int = 4096
    load_depth: bool = False

    device: str = "cuda"


def get_save_dir(cfg: EvalConfig) -> Path:
    """`<save_dir>/<ds_name>/<detection>+<coarse>`."""
    if cfg.save_dir is None:
        raise ValueError("EvalConfig.save_dir is not set")
    key = f"{cfg.inference.detection_type}+{cfg.inference.coarse_estimation_type}"
    return Path(cfg.save_dir) / cfg.ds_name / key


def _coerce(value: str, current: Any, hint: str = "") -> Any:
    """String -> field value, typed by the current value or (when the
    default is None) by the field's annotation `hint`; the JAX package's
    dotlist syntax (`training/config.py`)."""
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        parts = [p for p in value.strip("[]() ").split(",") if p]
        elem = current[0] if current else value
        return tuple(type(elem)(p.strip()) for p in parts)
    if isinstance(current, list) or (current is None and "list" in hint):
        try:
            out = json.loads(value)
            return out if isinstance(out, list) else [out]
        except json.JSONDecodeError:
            return [p.strip() for p in value.split(",") if p.strip()]
    if current is None and "int" in hint:
        return int(value)
    if current is None and "float" in hint:
        return float(value)
    if current is None and not hint:
        try:
            return json.loads(value)
        except json.JSONDecodeError:
            return value
    return value


def apply_eval_overrides(cfg: EvalConfig, argv: list[str]) -> EvalConfig:
    """`key=value` overrides, `inference.<field>=value` for the nested
    inference configuration."""
    hints = {f.name: str(f.type) for f in dataclasses.fields(cfg)}
    updates: dict[str, Any] = {}
    inf_updates: dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        if key.startswith("inference."):
            f = key[len("inference."):]
            if not hasattr(cfg.inference, f):
                raise ValueError(f"unknown key {key!r}")
            inf_updates[f] = _coerce(value, getattr(cfg.inference, f))
        else:
            if not hasattr(cfg, key) or key == "inference":
                raise ValueError(f"unknown config key {key!r}")
            updates[key] = _coerce(value, getattr(cfg, key), hints.get(key, ""))
    if inf_updates:
        updates["inference"] = dataclasses.replace(cfg.inference, **inf_updates)
    return dataclasses.replace(cfg, **updates)
