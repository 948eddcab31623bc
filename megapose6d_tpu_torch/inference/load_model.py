"""Build the coarse and refiner models and the mesh database, and the
named megapose-1.0 configurations.

Counterpart of `load_or_init_models` in
`megapose6d_tpu/scripts/run_inference_on_example.py` and of `NAMED_MODELS`
and `load_named_model` in `megapose6d_tpu/inference/load_model.py`. A run directory
gives the model configuration (`config.json`). The weights come from, in
order: a weight file given by name, either an npz of a JAX run's params
tree (flat keys joined by `/`, `backbone/Conv_0/kernel`, written from its
orbax checkpoint by `python -m tests.test_torch_checkpoints export <run>
<out.npz>` where the JAX package is installed) or a port checkpoint
(`state.pt`, or the checkpoint directory holding it, to name a step); the
run directory's latest port checkpoint (`checkpoints/latest.txt`, as
`run_training` and `run_detector_training` write them); else a seed, with
a warning. The JAX package's own checkpoints are orbax (OCDBT,
zstd-compressed), which the port does not read.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..interop.from_jax import config_from_run_json, state_dict_from_jax
from ..meshes.mesh_db import BatchedMeshes, MeshDataBase, RigidObjectDataset
from ..models.pose_predictor import PosePredictor, make_coarse_config, make_refiner_config
from .depth_refiner import DepthRefiner, GNCRegistrationRefiner, ICPRefiner
from .pose_estimator import PoseEstimator
from .types import InferenceConfig

logger = logging.getLogger(__name__)

NAMED_MODELS: dict[str, dict[str, Any]] = {
    "megapose-1.0-RGB": {
        "requires_depth": False,
        "refiner_kwargs": {},
        "inference_parameters": {"n_refiner_iterations": 5, "n_pose_hypotheses": 1},
    },
    "megapose-1.0-RGBD": {
        "requires_depth": True,
        "refiner_kwargs": {
            "input_depth": True,
            "render_depth": True,
            "depth_normalization_type": "tCR_scale_clamp_center",
        },
        "inference_parameters": {"n_refiner_iterations": 5, "n_pose_hypotheses": 1},
    },
    "megapose-1.0-RGB-multi-hypothesis": {
        "requires_depth": False,
        "refiner_kwargs": {},
        "inference_parameters": {"n_refiner_iterations": 5, "n_pose_hypotheses": 5},
    },
    "megapose-1.0-RGB-multi-hypothesis-icp": {
        "requires_depth": True,
        "refiner_kwargs": {},
        "depth_refiner": "ICP",
        "inference_parameters": {
            "n_refiner_iterations": 5,
            "n_pose_hypotheses": 5,
            "run_depth_refiner": True,
        },
    },
}


def load_params_npz(path: str | Path) -> dict[str, Any]:
    """An npz of `/`-joined param paths -> the nested params dict."""
    if Path(path).suffix != ".npz":
        raise ValueError(f"{path}: weights come from an npz export of a JAX run's params, not a run directory")
    tree: dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def npz_step(weights: str | Path | None) -> int:
    """The training step an export names (`<run>@<step>.npz`), else 0."""
    m = re.search(r"@(\d+)\.npz$", str(weights or ""))
    return int(m.group(1)) if m else 0


def run_checkpoint(run_dir: str | Path | None) -> Path | None:
    """The `state.pt` that a port run's `checkpoints/latest.txt` names
    (`epoch_N/` of `run_training`, `step_N/` of `run_detector_training`),
    or None (no such file: a JAX run, or no run)."""
    if not run_dir:
        return None
    ckpt = Path(run_dir) / "checkpoints"
    latest = ckpt / "latest.txt"
    if not latest.exists():
        return None
    n = latest.read_text().strip()
    for name in (f"epoch_{n}", f"step_{n}", n):
        if (ckpt / name / "state.pt").exists():
            return ckpt / name / "state.pt"
    return None


def weight_source(run_dir: str | Path | None, weights: str | Path | None) -> Path | None:
    """The weight file of a model: `weights` (an npz, a `state.pt` or a
    checkpoint directory holding one) if given, else the run's latest port
    checkpoint, else None."""
    if weights:
        path = Path(weights)
        return path / "state.pt" if path.is_dir() else path
    return run_checkpoint(run_dir)


def read_weights(path: Path, from_jax) -> dict[str, torch.Tensor]:
    """A module's state dict from an npz export (through `from_jax`) or the
    `params` of a port checkpoint."""
    if path.suffix == ".npz":
        return from_jax(load_params_npz(path))
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def build_model(
    run_dir: str | Path | None,
    weights: str | Path | None,
    default_config,
    render_size: tuple[int, int] = (240, 320),
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> PosePredictor:
    """One `PosePredictor`: the run's configuration (or `default_config`
    at `render_size`), with the weights of `weight_source(run_dir,
    weights)`, else drawn from `seed`."""
    cfg = (config_from_run_json(Path(run_dir) / "config.json")[0] if run_dir
           else default_config(render_size=tuple(render_size)))
    model = PosePredictor(cfg)
    source = weight_source(run_dir, weights)
    if source is not None:
        model.load_state_dict(read_weights(source, state_dict_from_jax))
    else:
        logger.warning("pose model weights drawn from seed %d (no weight file, no port checkpoint in %s)",
                       seed, run_dir)
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def load_or_init_models(
    object_dataset: RigidObjectDataset,
    coarse_run: str | Path | None = None,
    refiner_run: str | Path | None = None,
    coarse_weights: str | Path | None = None,
    refiner_weights: str | Path | None = None,
    render_size: tuple[int, int] = (240, 320),
    max_faces: int = 4096,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[PosePredictor, PosePredictor, BatchedMeshes]:
    """(coarse, refiner, mesh database) on `device`. Seeded weights use
    `seed` for the coarse model and `seed + 1` for the refiner."""
    mesh_db = MeshDataBase.from_object_ds(object_dataset, max_faces=max_faces).batched(device=device)
    coarse = build_model(coarse_run, coarse_weights, make_coarse_config, render_size, seed, device)
    refiner = build_model(refiner_run, refiner_weights, make_refiner_config, render_size, seed + 1, device)
    return coarse, refiner, mesh_db


def load_named_model(
    model_name: str,
    object_dataset: RigidObjectDataset,
    coarse_run: str | Path | None = None,
    refiner_run: str | Path | None = None,
    coarse_weights: str | Path | None = None,
    refiner_weights: str | Path | None = None,
    max_faces: int = 4096,
    compute_dtype: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
    **inference_overrides,
) -> PoseEstimator:
    """A `PoseEstimator` for a `NAMED_MODELS` configuration.

    A run directory gives a model's configuration (and an npz its
    weights); without one the model is the named configuration's (resnet34,
    240x320) with weights drawn from `seed` (coarse) and `seed + 1`
    (refiner), computing in `compute_dtype`, by default bfloat16 on the
    GPU and float32 on the CPU. `inference_overrides` update the named
    inference parameters. The depth refiner is ICP for `depth_refiner`
    "ICP" or `run_depth_refiner`, GNC-TLS for "teaserpp"."""
    info = NAMED_MODELS[model_name]
    device = torch.device(device)
    dtype = compute_dtype or ("bfloat16" if device.type == "cuda" else "float32")
    mesh_db = MeshDataBase.from_object_ds(object_dataset, max_faces=max_faces).batched(device=device)
    coarse = build_model(coarse_run, coarse_weights,
                         functools.partial(make_coarse_config, compute_dtype=dtype), seed=seed, device=device)
    refiner = build_model(refiner_run, refiner_weights,
                          functools.partial(make_refiner_config, compute_dtype=dtype, **info["refiner_kwargs"]),
                          seed=seed + 1, device=device)
    params = {**info["inference_parameters"], **inference_overrides}
    names = {f.name for f in dataclasses.fields(InferenceConfig)}
    cfg = InferenceConfig(**{k: v for k, v in params.items() if k in names})
    kind = info.get("depth_refiner")
    depth_refiner: DepthRefiner | None = None
    if kind == "teaserpp" or cfg.depth_refiner == "teaserpp":
        depth_refiner = GNCRegistrationRefiner(mesh_db)
    elif kind == "ICP" or cfg.run_depth_refiner:
        depth_refiner = ICPRefiner(mesh_db)
    return PoseEstimator(coarse, refiner, mesh_db, cfg, device=device, depth_refiner=depth_refiner)
