"""Build the coarse and refiner models and the mesh database, and the
named megapose-1.0 configurations.

Counterpart of `load_or_init_models` in
`megapose6d_tpu/scripts/run_inference_on_example.py` and of `NAMED_MODELS`
and `load_named_model` in `megapose6d_tpu/inference/load_model.py`. A run directory
gives the model configuration (`config.json`) and its weights: the
checkpoint that `checkpoints/latest.txt` names (or a given epoch), either
the JAX package's orbax checkpoint (`epoch_N/`, read by
`interop/orbax.py` with the port's own zstd decoder and OCDBT reader) or
the port's (`epoch_N/state.pt` of `run_training`, `step_N/state.pt` of
`run_detector_training`). A weights argument overrides it: an npz of a JAX
run's params tree (flat keys joined by `/`, `backbone/Conv_0/kernel`), a
port `state.pt`, an orbax or port checkpoint directory, a run directory, or
a reference `checkpoint.pth.tar`. A run directory without a readable
checkpoint raises. Weights are drawn from a seed, with a warning, only
when neither a run nor weights are given, as the JAX package initialises
only without a run.
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
from ..interop.orbax import is_orbax_checkpoint, read_checkpoint
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


def weights_step(weights: str | Path | None) -> int:
    """The training step a weight source names: `<run>@<step>.npz`, or a
    checkpoint directory `epoch_<step>` / `step_<step>` (or its
    `state.pt`); else 0."""
    text = str(weights or "")
    m = re.search(r"@(\d+)\.npz$", text) or re.search(r"(?:epoch|step)_(\d+)(?:/state\.pt)?/?$", text)
    return int(m.group(1)) if m else 0


def run_checkpoint(run_dir: str | Path | None, epoch: int | str | None = None) -> Path | None:
    """A run's checkpoint at `epoch` (None: the one `checkpoints/latest.txt`
    names): a port run's `state.pt` (`epoch_N/` of `run_training`,
    `step_N/` of `run_detector_training`) or a JAX run's orbax directory
    (`epoch_N/`, `step_N/`). None when there is no run, or no epoch is
    given and the run has no `latest.txt`; FileNotFoundError when the
    named checkpoint is missing."""
    if not run_dir:
        return None
    ckpt = Path(run_dir) / "checkpoints"
    if epoch is None:
        latest = ckpt / "latest.txt"
        if not latest.exists():
            return None
        epoch = latest.read_text().strip()
    names = (f"epoch_{epoch}", f"step_{epoch}", str(epoch))
    for name in names:
        if (ckpt / name / "state.pt").exists():
            return ckpt / name / "state.pt"
    for name in names:
        if is_orbax_checkpoint(ckpt / name):
            return ckpt / name
    raise FileNotFoundError(f"{ckpt} holds no checkpoint {epoch} (no state.pt and no orbax checkpoint "
                            f"in {', '.join(names)})")


def _run_weights(run_dir: str | Path, epoch: int | str | None) -> Path:
    source = run_checkpoint(run_dir, epoch)
    if source is None:
        raise FileNotFoundError(f"{run_dir} has no checkpoints/latest.txt: name a checkpoint or weight file")
    return source


def weight_source(run_dir: str | Path | None, weights: str | Path | None,
                  epoch: int | str | None = None) -> Path | None:
    """The weights of a model: `weights` if given (an npz, a `state.pt`, a
    `.pth.tar`, a port or orbax checkpoint directory, or a run directory,
    whose checkpoint at `epoch` it names), else the checkpoint of
    `run_dir` at `epoch` (None: its latest), else None (no run: seeded).
    A run directory without that checkpoint raises FileNotFoundError."""
    if weights:
        path = Path(weights)
        if (path / "checkpoints").is_dir():
            return _run_weights(path, epoch)
        if path.is_dir() and not is_orbax_checkpoint(path):
            return path / "state.pt"
        return path
    if run_dir:
        return _run_weights(run_dir, epoch)
    return None


def read_weights(path: Path, from_jax) -> dict[str, torch.Tensor]:
    """A module's state dict from a JAX run's params (an orbax checkpoint
    directory or an npz export, through `from_jax`), a reference MegaPose
    `checkpoint.pth.tar` (`interop.torch_convert`), or the `params` and
    `buffers` of a port checkpoint."""
    if path.suffix == ".npz":
        return from_jax(load_params_npz(path))
    if is_orbax_checkpoint(path):
        return from_jax(read_checkpoint(path, prefixes=["params"])["params"])
    if path.name.endswith(".pth.tar"):
        from ..interop.torch_convert import load_torch_pose_checkpoint

        return load_torch_pose_checkpoint(path)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return {**saved["params"], **saved.get("buffers", {})}


def build_model(
    run_dir: str | Path | None,
    weights: str | Path | None,
    default_config,
    render_size: tuple[int, int] = (240, 320),
    seed: int = 0,
    device: str | torch.device = "cuda",
    epoch: int | str | None = None,
) -> PosePredictor:
    """One `PosePredictor`: the run's configuration (or `default_config`
    at `render_size`), with the weights of `weight_source(run_dir,
    weights, epoch)`; drawn from `seed` only when neither a run nor
    weights are given."""
    cfg = (config_from_run_json(Path(run_dir) / "config.json")[0] if run_dir
           else default_config(render_size=tuple(render_size)))
    model = PosePredictor(cfg)
    source = weight_source(run_dir, weights, epoch)
    if source is not None:
        model.load_state_dict(read_weights(source, state_dict_from_jax))
    else:
        logger.warning("pose model weights drawn from seed %d (no run directory, no weight file)", seed)
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def load_or_init_models(
    object_dataset: RigidObjectDataset,
    coarse_run: str | Path | None = None,
    refiner_run: str | Path | None = None,
    render_size: tuple[int, int] = (240, 320),
    max_faces: int = 4096,
    coarse_weights: str | Path | None = None,
    refiner_weights: str | Path | None = None,
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
    runs: dict[str, str | Path] | None = None,
    max_faces: int = 4096,
    compute_dtype: str | None = None,
    *,
    coarse_run: str | Path | None = None,
    refiner_run: str | Path | None = None,
    coarse_weights: str | Path | None = None,
    refiner_weights: str | Path | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
    **inference_overrides,
) -> PoseEstimator:
    """A `PoseEstimator` for a `NAMED_MODELS` configuration.

    `runs` is `{"coarse": run_dir, "refiner": run_dir}`, as in the JAX
    package; `coarse_run` / `refiner_run` name one role's run alone. A run
    directory gives a model's configuration and weights (a weights
    argument overrides them); without one the model is the named configuration's (resnet34,
    240x320) with weights drawn from `seed` (coarse) and `seed + 1`
    (refiner), computing in `compute_dtype`, by default bfloat16 on the
    GPU and float32 on the CPU. `inference_overrides` update the named
    inference parameters. The depth refiner is ICP for `depth_refiner`
    "ICP" or `run_depth_refiner`, GNC-TLS for "teaserpp"."""
    info = NAMED_MODELS[model_name]
    runs = runs or {}
    coarse_run = coarse_run or runs.get("coarse")
    refiner_run = refiner_run or runs.get("refiner")
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
