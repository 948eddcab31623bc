"""Build the coarse and refiner models and the mesh database.

Counterpart of `load_or_init_models` in
`megapose6d_tpu/scripts/run_inference_on_example.py`. A run directory
gives the model configuration (`config.json`). The JAX package's
checkpoints are orbax (OCDBT, zstd-compressed), which the port does not
read; the weights come instead from an npz of the params tree, flat keys
joined by `/` (`backbone/Conv_0/kernel`), written from the checkpoint by
`python -m tests.test_torch_checkpoints export <run> <out.npz>` where the
JAX package is installed. Without an npz the weights are drawn from a seed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..interop.from_jax import config_from_run_json, state_dict_from_jax
from ..meshes.mesh_db import BatchedMeshes, MeshDataBase, RigidObjectDataset
from ..models.pose_predictor import PosePredictor, make_coarse_config, make_refiner_config


def load_params_npz(path: str | Path) -> dict[str, Any]:
    """An npz of `/`-joined param paths -> the nested params dict."""
    tree: dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def build_model(
    run_dir: str | Path | None,
    weights: str | Path | None,
    default_config,
    render_size: tuple[int, int] = (240, 320),
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> PosePredictor:
    """One `PosePredictor`: the run's configuration (or `default_config`
    at `render_size`), with the npz's weights or weights drawn from `seed`."""
    cfg = (config_from_run_json(Path(run_dir) / "config.json")[0] if run_dir
           else default_config(render_size=tuple(render_size)))
    model = PosePredictor(cfg)
    if weights:
        model.load_state_dict(state_dict_from_jax(load_params_npz(weights)))
    else:
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
