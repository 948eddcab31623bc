"""The synthetic demo's pose errors and its short training.

Counterpart of `pose_errors` and `train_model` of
`megapose6d_tpu/scripts/demo_synthetic_e2e.py`; its `build_world` is
`meshes/worlds.py`'s, and the rest of that script (its own end-to-end run
and report) is not ported. `train_model` trains on the port's trainer
(`training/train.py`), whose draws come from torch generators, so its
weights are not the JAX script's.
"""

from __future__ import annotations

import logging
import time

import torch

from ..meshes.mesh_db import BatchedMeshes
from ..ops.se3 import geodesic_distance, transform_pts
from ..training import train as tt
from ..training.config import TrainingConfig

logger = logging.getLogger(__name__)
Tensor = torch.Tensor


def pose_errors(TCO_pred: Tensor, TCO_gt: Tensor, points: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Per pose: ADD (mean distance of `points [B, P, 3]` under the two
    poses, metres), rotation error (degrees) and translation error
    (metres)."""
    add = torch.linalg.norm(transform_pts(TCO_pred, points) - transform_pts(TCO_gt, points), dim=-1).mean(-1)
    rot = torch.rad2deg(geodesic_distance(TCO_pred[:, :3, :3], TCO_gt[:, :3, :3]))
    trans = torch.linalg.norm(TCO_pred[:, :3, 3] - TCO_gt[:, :3, 3], dim=-1)
    return add, rot, trans


def train_model(cfg: TrainingConfig, mesh_db: BatchedMeshes, n_steps: int, input_res: tuple[int, int],
                tag: str) -> tuple[torch.nn.Module, tt.TrainState, list[float]]:
    """`n_steps` steps of `cfg` on synthetic batches at `input_res` (focal
    400) on the DB's device. Returns (the model in eval mode, the train
    state, the loss at the first step and every 50th)."""
    state = tt.create_train_state(cfg, device=mesh_db.device)
    batches = tt.synthetic_batch_fn(mesh_db, cfg.batch_size, input_res, f=400.0, device=mesh_db.device)
    t0 = time.monotonic()
    losses = []
    for i in range(n_steps):
        batch = batches(tt.step_generator(cfg.seed, tt.BATCH_STREAM, i))
        draws = tt.step_draws(cfg, batch, mesh_db, tt.DRAW_STREAM, i)
        metrics = tt.train_step(state, cfg, batch, mesh_db, draws, cfg.n_iterations)
        if (i + 1) % 50 == 0 or i == 0:
            losses.append(metrics["loss_total"])
            logger.info("[%s] step %d/%d loss=%.4f (%.2fs/step)", tag, i + 1, n_steps,
                        metrics["loss_total"], (time.monotonic() - t0) / (i + 1))
    return state.model.eval(), state, losses
