"""Training debug visualization: observation crops beside hypothesis
renders, in a PNG grid.

Counterpart of `megapose6d_tpu/training/visualization.py`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..meshes.mesh_db import BatchedMeshes
from ..models.pose_predictor import PosePredictor
from .forward_loss import BatchPoseData


@torch.no_grad()
def make_debug_visualization(
    model: PosePredictor,
    batch: BatchPoseData,
    mesh_db: BatchedMeshes,
    out_path: str | Path,
    max_samples: int = 4,
) -> np.ndarray:
    """One `score_views` (a coarse model) or `refine_step` (a refiner) of
    `model` on the first `max_samples` samples of `batch` at their poses,
    saved as rows of [observation crop | render] (rgb channels); returns
    the grid."""
    from ..visualization.plotter import save_image_grid

    n = min(max_samples, batch.batch_size)
    meshes = mesh_db.select(batch.mesh_idx[:n])
    step = model.score_views if model.cfg.predict_rendered_views_logits else model.refine_step
    out = step(batch.images()[:n], batch.K[:n], batch.TCO[:n], meshes)
    rgb = lambda x: x[..., :3].float().cpu().numpy()  # noqa: E731
    tiles = [t for i in range(n) for t in (rgb(out["images_crop"][i]), rgb(out["renders"][i]))]
    return save_image_grid(tiles, out_path, n_cols=2)
