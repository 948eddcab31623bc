"""End-to-end demo: train a refiner and a coarse scorer on synthetic
scenes, then measure the pose accuracy of the full pipeline.

Counterpart of `megapose6d_tpu/scripts/demo_synthetic_e2e.py` (its
`build_world` is `meshes/worlds.py`'s). Writes `<out_dir>/report.json`
with the JAX script's keys: ADD, rotation and translation errors of (a)
the noised initial poses, (b) the refiner applied to them and (c) the
full coarse -> refine pipeline from ground-truth boxes. Training runs on
the port's trainer (`training/train.py`), whose draws come from torch
generators, so its weights are not the JAX script's; the evaluation
scenes (`synthetic_batch_fn` at key 9999) and their pose noise (key 7)
are drawn as the JAX script draws them (`utils/threefry.py`).

    python -m megapose6d_tpu_torch.scripts.demo_synthetic_e2e out_dir=demo \\
        n_steps=600 [coarse_steps=400] [batch_size=16] [render=120,160] [input=240,320] [device=cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.types import ObservationTensor
from ..inference.pose_estimator import PoseEstimator
from ..inference.types import InferenceConfig, make_detections
from ..meshes.mesh_db import BatchedMeshes
from ..meshes.worlds import build_world
from ..ops._precision import pin_f32
from ..ops.se3 import add_pose_noise, geodesic_distance, transform_pts
from ..training import train as tt
from ..training.config import TrainingConfig, make_coarse_cfg, make_refiner_cfg
from ..training.forward_loss import BatchPoseData
from ..utils import threefry

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


def eval_draws(n_labels: int, batch_size: int) -> dict[str, Tensor]:
    """The draws of the JAX package's `synthetic_batch_fn` at `PRNGKey(9999)`
    (object, pool rotation, depth, lateral offset), for
    `SyntheticBatches.make`: the demos' held-out scenes."""
    k1, k2, k3, k4 = threefry.split(threefry.PRNGKey(9999), 4)
    B = batch_size
    return {
        "mesh_idx": torch.as_tensor(threefry.randint(k1, (B,), 0, n_labels), dtype=torch.long),
        "quat_idx": torch.as_tensor(threefry.randint(k2, (B,), 0, 4096), dtype=torch.long),
        "z": torch.as_tensor(threefry.uniform(k3, (B, 1), 0.35, 0.9)),
        "xy": torch.as_tensor(threefry.uniform(k4, (B, 2), -0.05, 0.05)),
    }


def noise_draws(batch_size: int) -> tuple[Tensor, Tensor]:
    """The standard normals of the JAX package's `add_pose_noise` at
    `PRNGKey(7)`: (euler `[B, 3]`, translation `[B, 3]`)."""
    kr, kt = threefry.split(threefry.PRNGKey(7))
    return (torch.as_tensor(threefry.normal(kr, (batch_size, 3))),
            torch.as_tensor(threefry.normal(kt, (batch_size, 3))))


def eval_set(mesh_db: BatchedMeshes, n_eval: int, input_res: tuple[int, int]) -> tuple[BatchPoseData, Tensor]:
    """The held-out scenes (key 9999) rendered on the DB's device, and
    their ground-truth poses noised with the key-7 normals (15 degrees,
    1/1/5 cm standard deviations)."""
    device = mesh_db.device
    synth = tt.synthetic_batch_fn(mesh_db, n_eval, input_res, f=400.0, device=device)
    batch = synth.make({k: v.to(device) for k, v in eval_draws(len(mesh_db.labels), n_eval).items()})
    euler, trans = noise_draws(n_eval)
    TCO_init = add_pose_noise(batch.TCO, euler_deg_std=(15, 15, 15), trans_std=(0.01, 0.01, 0.05),
                              euler_normals=euler.to(device), trans_normals=trans.to(device))
    return batch, TCO_init


@torch.no_grad()
def refine_n(refiner, batch: BatchPoseData, meshes: BatchedMeshes, TCO: Tensor, n: int) -> Tensor:
    """`n` refiner iterations from `TCO` on the batch's observations."""
    for _ in range(n):
        TCO = refiner.refine_step(batch.rgbs, batch.K, TCO, meshes)["TCO_output"]
    return TCO


def main(argv=None) -> dict:
    args = dict(out_dir="demo_e2e", n_steps="600", coarse_steps="400", batch_size="16", render="120,160",
                input="240,320", n_eval="16", refine_iters="3", so3="128", seed="0", device="cuda")
    for a in sys.argv[1:] if argv is None else argv:
        k, _, v = a.partition("=")
        if k not in args:
            raise ValueError(f"unknown arg {k}")
        args[k] = v
    pin_f32()
    out_dir = Path(args["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    render = tuple(int(x) for x in args["render"].split(","))
    input_res = tuple(int(x) for x in args["input"].split(","))
    device = torch.device(args["device"])
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    mesh_db = build_world(device=device)
    logger.info("world: %s; device %s", mesh_db.labels, device)

    base = TrainingConfig(
        input_resize=input_res, render_size=render, batch_size=int(args["batch_size"]),
        # Spatial-pool head: global-average-pooled backbones do not learn
        # rotation at this data scale.
        backbone_str="resnet18-spatial", compute_dtype=dtype, n_points_loss=256, lr=3e-4, n_epochs_warmup=1,
        lr_epoch_decay=10**6, epoch_size=int(args["batch_size"]), seed=int(args["seed"]),
    )
    ref_cfg = dataclasses.replace(make_refiner_cfg(base), n_rendered_views=2, multiview_type="front_1view",
                                  n_iterations=1)
    refiner, _, ref_losses = train_model(ref_cfg, mesh_db, int(args["n_steps"]), input_res, "refiner")
    coarse_cfg = dataclasses.replace(make_coarse_cfg(base), n_hypotheses=4)
    coarse, _, coarse_losses = train_model(coarse_cfg, mesh_db, int(args["coarse_steps"]), input_res, "coarse")

    # (a/b) refiner only: noised ground truth -> n iterations.
    n_eval, n_it = int(args["n_eval"]), int(args["refine_iters"])
    batch, TCO_init = eval_set(mesh_db, n_eval, input_res)
    meshes = mesh_db.select(batch.mesh_idx)
    TCO_refined = refine_n(refiner, batch, meshes, TCO_init, n_it)
    pts = meshes.points[:, :256]
    add0, rot0, tr0 = (x.cpu().numpy() for x in pose_errors(TCO_init, batch.TCO, pts))
    add1, rot1, tr1 = (x.cpu().numpy() for x in pose_errors(TCO_refined, batch.TCO, pts))

    # (c) the full pipeline from ground-truth boxes, one object a frame.
    est = PoseEstimator(coarse, refiner, mesh_db, InferenceConfig(
        SO3_grid_size=int(args["so3"]), n_refiner_iterations=n_it, n_pose_hypotheses=4, bsz_images=64,
        bsz_objects=16, max_detections=1), device=device)
    pipe = []
    labels = list(mesh_db.labels)
    for i in range(min(n_eval, 8)):
        obs = ObservationTensor(batch.rgbs[i : i + 1], batch.K[i : i + 1])
        det = make_detections([labels[int(batch.mesh_idx[i])]], batch.bboxes[i : i + 1].cpu().numpy(), device=device)
        data, _ = est.run_inference_pipeline(obs, det)
        pipe.append([float(x[0]) for x in pose_errors(data.poses, batch.TCO[i : i + 1], pts[i : i + 1])])
    pipe_add, pipe_rot, pipe_tr = (np.asarray(c) for c in zip(*pipe))

    diam = float(mesh_db.diameters.mean())
    report = {
        "device": str(device),
        "refiner_losses": ref_losses,
        "coarse_losses": coarse_losses,
        "refine_iters": n_it,
        "init": {"add_median": float(np.median(add0)), "rot_deg_median": float(np.median(rot0)),
                 "trans_median": float(np.median(tr0))},
        "refined": {"add_median": float(np.median(add1)), "rot_deg_median": float(np.median(rot1)),
                    "trans_median": float(np.median(tr1)), "add_improved_frac": float((add1 < add0).mean())},
        "pipeline": {"add_median": float(np.median(pipe_add)), "rot_deg_median": float(np.median(pipe_rot)),
                     "trans_median": float(np.median(pipe_tr)),
                     "add_below_0.1d_frac": float((pipe_add < 0.1 * diam).mean())},
        "mean_diameter": diam,
    }
    (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    logger.info("%s", json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
