"""Evaluation configuration, its save directory and `key=value` overrides.

Counterpart of `EvalConfig`, `FullEvalConfig`, `get_save_dir`,
`apply_eval_overrides` and `save_eval_config` in
`megapose6d_tpu/evaluation/eval_config.py`, with the fields the port
reads. The port adds `coarse_weights` / `refiner_weights` /
`detector_weights` (npz files of the runs' params, see
`inference/load_model.py`; empty: weights drawn from a fixed seed),
`data_dir` (the root holding `<ds_name>/`; empty:
`MEGAPOSE_DATA_DIR/bop_datasets`) and `device`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

from ..inference.types import InferenceConfig
from ..training.config import _coerce


@dataclasses.dataclass
class EvalConfig:
    """One (dataset, detection type, coarse type) evaluation."""

    # Networks: run directories (their config.json; the detector's also
    # labels.json) and weight files.
    detector_run: str = ""
    coarse_run: str = ""
    refiner_run: str = ""
    detector_weights: str = ""
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

    # This process's share of the frames (`runner.shard_frames`).
    rank: int = 0
    world_size: int = 1

    device: str = "cuda"


@dataclasses.dataclass
class FullEvalConfig(EvalConfig):
    """A sweep: every dataset of `ds_names` under every (detection type,
    coarse estimation type) pair of `detection_coarse_types`."""

    detection_coarse_types: list = dataclasses.field(default_factory=lambda: [("gt", "SO3_grid")])
    ds_names: Optional[list] = None


def get_save_dir(cfg: EvalConfig) -> Path:
    """`<save_dir>/<ds_name>/<detection>+<coarse>`."""
    if cfg.save_dir is None:
        raise ValueError("EvalConfig.save_dir is not set")
    key = f"{cfg.inference.detection_type}+{cfg.inference.coarse_estimation_type}"
    return Path(cfg.save_dir) / cfg.ds_name / key


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
        elif key == "detection_coarse_types":  # "gt:SO3_grid,detector:SO3_grid"
            updates[key] = [tuple(p.split(":")) for p in value.split(",") if p]
        elif key == "ds_names":
            updates[key] = [n for n in value.split(",") if n]
        else:
            if not hasattr(cfg, key) or key == "inference":
                raise ValueError(f"unknown config key {key!r}")
            updates[key] = _coerce(value, getattr(cfg, key), hints.get(key, ""))
    if inf_updates:
        updates["inference"] = dataclasses.replace(cfg.inference, **inf_updates)
    return dataclasses.replace(cfg, **updates)


def save_eval_config(cfg: EvalConfig, path: str | Path) -> None:
    Path(path).write_text(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
