"""Evaluation configuration, its save directory and `key=value` overrides.

Counterpart of `megapose6d_tpu/evaluation/eval_config.py`: `HardwareConfig`,
`EvalConfig`, `FullEvalConfig`, `BOPEvalConfig`, `generate_save_key`,
`get_save_dir`, `apply_eval_overrides` and `save_eval_config`, with every
field of the JAX package's configurations, so that its dotlists
(`hardware.n_cpus=8`, `run_bop_eval=1`) apply here too. `hardware`,
`result_id`, `n_dataloader_workers` and `global_batch_size` are recorded
and not read, as in the JAX package. The port adds `coarse_weights` / `refiner_weights` /
`detector_weights` (weight files that override the run directories'
checkpoints, see `inference/load_model.py`; empty: the runs' own),
`data_dir` (the root holding `<ds_name>/`; empty:
`MEGAPOSE_DATA_DIR/bop_datasets`) and `device`, keyword-only, so that the
JAX package's positional order holds.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

from ..inference.types import InferenceConfig
from ..training.config import _coerce

# BOP19 challenge test sets.
BOP_TEST_DATASETS = [
    "lmo.bop19",
    "tless.bop19",
    "tudl.bop19",
    "icbin.bop19",
    "itodd.bop19",
    "hb.bop19",
    "ycbv.bop19",
]


@dataclasses.dataclass
class HardwareConfig:
    n_cpus: int = 8
    n_chips: int = 1


@dataclasses.dataclass
class EvalConfig:
    """One (dataset, detection type, coarse type) evaluation."""

    # Networks: run directories (their config.json; the detector's also
    # labels.json) and weight files.
    detector_run: str = ""
    coarse_run: str = ""
    refiner_run: str = ""
    detector_weights: str = dataclasses.field(default="", kw_only=True)
    coarse_weights: str = dataclasses.field(default="", kw_only=True)
    refiner_weights: str = dataclasses.field(default="", kw_only=True)

    # Dataset.
    ds_name: str = "ycbv.bop19"
    data_dir: str = dataclasses.field(default="", kw_only=True)

    inference: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)

    # Run management.
    result_id: Optional[str] = None
    save_dir: Optional[str] = None
    n_frames: Optional[int] = None
    n_dataloader_workers: int = 8
    skip_inference: bool = False
    skip_evaluation: bool = False

    # Models built without a run directory, and the mesh database.
    render_size: tuple[int, int] = (240, 320)
    max_faces: int = 4096
    load_depth: bool = False

    # This process's share of the frames (`runner.shard_frames`).
    rank: int = 0
    world_size: int = 1

    global_batch_size: Optional[int] = None
    hardware: HardwareConfig = dataclasses.field(default_factory=HardwareConfig)
    # With `run_bop_eval`, bop_toolkit's dummy script instead of its scoring.
    debug: bool = False

    device: str = dataclasses.field(default="cuda", kw_only=True)


@dataclasses.dataclass
class FullEvalConfig(EvalConfig):
    """A sweep: every dataset of `ds_names` under every (detection type,
    coarse estimation type) pair of `detection_coarse_types`."""

    detection_coarse_types: list = dataclasses.field(default_factory=lambda: [("gt", "SO3_grid")])
    ds_names: Optional[list] = None
    # Score each BOP19 dataset's results CSV with bop_toolkit's
    # `eval_bop19.py` (`evaluation/bop.run_bop_evaluation`), found in
    # `bop_toolkit_dir`; nothing is scored without it.
    run_bop_eval: bool = False
    bop_toolkit_dir: str = ""
    modelnet_categories: Optional[list] = None


@dataclasses.dataclass
class BOPEvalConfig:
    """One bop_toolkit scoring run."""

    results_path: str
    dataset: str
    split: str
    eval_dir: str
    method: str  # "final", "depth_refiner", ...
    detection_method: Optional[str] = None
    convert_only: bool = False


def generate_save_key(detection_type: str, coarse_estimation_type: str) -> str:
    return f"{detection_type}+{coarse_estimation_type}"


def get_save_dir(cfg: EvalConfig) -> Path:
    """`<save_dir>/<ds_name>/<detection>+<coarse>`."""
    if cfg.save_dir is None:
        raise ValueError("EvalConfig.save_dir is not set")
    key = generate_save_key(cfg.inference.detection_type, cfg.inference.coarse_estimation_type)
    return Path(cfg.save_dir) / cfg.ds_name / key


def apply_eval_overrides(cfg: EvalConfig, argv: list[str]) -> EvalConfig:
    """`key=value` overrides, `inference.<field>=value` and
    `hardware.<field>=value` for the nested configurations."""
    hints = {f.name: str(f.type) for f in dataclasses.fields(cfg)}
    updates: dict[str, Any] = {}
    nested: dict[str, dict[str, Any]] = {"inference": {}, "hardware": {}}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        group, _, f = key.partition(".")
        if group in nested and f:
            if not hasattr(getattr(cfg, group), f):
                raise ValueError(f"unknown key {key!r}")
            nested[group][f] = _coerce(value, getattr(getattr(cfg, group), f))
        elif key == "detection_coarse_types":  # "gt:SO3_grid,detector:SO3_grid"
            updates[key] = [tuple(p.split(":")) for p in value.split(",") if p]
        elif key == "ds_names":
            updates[key] = [n for n in value.split(",") if n]
        else:
            if not hasattr(cfg, key) or key in nested:
                raise ValueError(f"unknown config key {key!r}")
            updates[key] = _coerce(value, getattr(cfg, key), hints.get(key, ""))
    for group, values in nested.items():
        if values:
            updates[group] = dataclasses.replace(getattr(cfg, group), **values)
    return dataclasses.replace(cfg, **updates)


def save_eval_config(cfg: EvalConfig, path: str | Path) -> None:
    Path(path).write_text(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
