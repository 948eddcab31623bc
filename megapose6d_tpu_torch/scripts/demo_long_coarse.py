"""Long-schedule coarse-scorer training in resumable segments, with a
ranking evaluation over SO(3) grids.

Counterpart of `megapose6d_tpu/scripts/demo_long_coarse.py`: the
`coarse_classif_multiview_paper` objective (4 hypotheses) on the
synthetic world at a long schedule on the port's trainer, in segments of
at most `max_seconds` (run again on the same `out_dir` to resume from the
latest checkpoint). Every `eval_every` steps, and at the end, each
held-out scene scores the hypotheses of each SO(3) grid of `grid`, and
`history.json` records the median geodesic error of the top-scored
rotation, the share of scenes whose top 4 hold a rotation within 15
degrees of the grid's best, and the grid's own floor. Checkpoints are
`torch.save` (`checkpoints/epoch_<step>/state.pt`); the port has no
compilation cache to enable.

    python -m megapose6d_tpu_torch.scripts.demo_long_coarse out_dir=build/coarse_long \\
        max_seconds=1200 [n_steps=30000] [grid=64,576] [batch_size=32] [device=cpu]
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

from ..meshes.worlds import build_world
from ..ops._precision import pin_f32
from ..ops.pose_init import tco_init_from_boxes_autodepth_with_R
from ..ops.se3 import geodesic_distance
from ..ops.so3_grid import make_so3_grid
from ..training import train as tt
from ..training.config import TrainingConfig, make_coarse_cfg, save_config
from .demo_long_refiner import parse_args, train_steps
from .demo_synthetic_e2e import eval_set

logger = logging.getLogger(__name__)

DEFAULTS = dict(
    out_dir="coarse_long", n_steps="30000", batch_size="32", eval_every="2000", max_seconds="1200",
    grid="64,576", backbone="resnet18-spatial", render="240,320", lr="3e-4", seed="0", n_eval="32",
    dtype="auto", force_final_eval="0",
    # domain_rand=1: randomized training observations (the ranking
    # evaluation stays on the unlit set).
    domain_rand="0",
    device="cuda",
)


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv, DEFAULTS)
    pin_f32()
    out_dir = Path(args["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    input_res = tuple(int(x) for x in args["render"].split(","))
    n_steps, eval_every = int(args["n_steps"]), int(args["eval_every"])
    device = torch.device(args["device"])
    if args["dtype"] == "auto":
        dtype = "bfloat16" if device.type == "cuda" else "float32"
    else:
        dtype = args["dtype"]  # the bf16-vs-f32 ranking A/B
    mesh_db = build_world(device=device)
    base = TrainingConfig(
        input_resize=input_res, render_size=input_res, batch_size=int(args["batch_size"]),
        backbone_str=args["backbone"], compute_dtype=dtype, n_points_loss=256, lr=float(args["lr"]),
        n_epochs_warmup=200, lr_epoch_decay=10**6, epoch_size=int(args["batch_size"]), seed=int(args["seed"]),
    )
    cfg = dataclasses.replace(make_coarse_cfg(base), n_hypotheses=4)
    save_config(cfg, out_dir / "config.json")
    state = tt.create_train_state(cfg, device=device)
    start_step = 0
    if (out_dir / "checkpoints" / "latest.txt").exists():
        state, start_step = tt.load_checkpoint(out_dir, state)
        logger.info("resumed from step %d", start_step)
    synth = tt.synthetic_batch_fn(mesh_db, cfg.batch_size, input_res, f=400.0,
                                  domain_rand=args["domain_rand"] == "1", device=device)

    # Ranking evaluation: each held-out scene scores a grid of hypotheses.
    n_eval = int(args["n_eval"])
    grids = [int(g) for g in args["grid"].split(",")]
    batch, _ = eval_set(mesh_db, n_eval, input_res)
    meshes = mesh_db.select(batch.mesh_idx)

    @torch.no_grad()
    def grid_scores(i: int, R_grid: torch.Tensor) -> np.ndarray:
        """Logits `[G]` of scene `i`'s hypotheses at the grid's rotations."""
        G = R_grid.shape[0]
        K = batch.K[i].expand(G, 3, 3)
        pts = meshes.points[i].expand((G,) + meshes.points.shape[1:])
        TCO = tco_init_from_boxes_autodepth_with_R(batch.bboxes[i].expand(G, 4), pts, K, R_grid)
        out = state.model.score_views(batch.rgbs[i : i + 1], K, TCO, mesh_db.select(batch.mesh_idx[i].expand(G)))
        return out["logits"][:, 0].float().cpu().numpy()

    history_path = out_dir / "history.json"
    history = json.loads(history_path.read_text()) if history_path.exists() else []
    history = [r for r in history if r["step"] <= start_step]

    def run_eval_grid(step: int, G: int) -> dict:
        R_grid = make_so3_grid(G, device=device)
        top1_err, top4_hit, floors = [], [], []
        for i in range(n_eval):
            s = grid_scores(i, R_grid)
            errs = np.degrees(geodesic_distance(R_grid, batch.TCO[i, :3, :3][None]).cpu().numpy())
            order = np.argsort(-s, kind="stable")
            top1_err.append(float(errs[order[0]]))
            floors.append(float(errs.min()))
            top4_hit.append(float(errs[order[:4]].min() <= errs.min() + 15.0))
        rec = {
            "step": step, "grid": G, "dtype": dtype,
            "top1_rot_err_deg_median": float(np.median(top1_err)),
            "top4_within_15deg_of_best_frac": float(np.mean(top4_hit)),
            "grid_best_reachable_deg_median": float(np.median(floors)),
        }
        history.append(rec)
        history_path.write_text(json.dumps(history, indent=1))
        logger.info("[eval @ %d, grid %d] top1 rot err %.1f deg (grid floor %.1f) | top4 near-best %.0f%%", step,
                    G, rec["top1_rot_err_deg_median"], rec["grid_best_reachable_deg_median"],
                    100 * rec["top4_within_15deg_of_best_frac"])
        return rec

    def run_eval(step: int) -> dict:
        rec = None
        for G in grids:
            rec = run_eval_grid(step, G)
        return rec

    def on_step(i: int, metrics: dict, t0: float) -> None:
        if i % 500 == 0 or i == start_step + 1:
            logger.info("step %d/%d bce=%.4f acc=%.3f (%.2fs/step)", i, n_steps,
                        metrics.get("loss_renderings_confidence", -1), metrics.get("views_accuracy", -1),
                        (time.monotonic() - t0) / (i - start_step))
        if i % eval_every == 0:
            run_eval(i)
            tt.save_checkpoint(out_dir, state, i)

    i = train_steps(state, cfg, synth, mesh_db, start_step, n_steps, float(args["max_seconds"]), on_step)
    # No trailing checkpoint and evaluation when they would repeat the last
    # record; force_final_eval=1 evaluates again anyway (a dtype A/B of the
    # same weights, told apart by the record's "dtype").
    if not history or history[-1]["step"] != i:
        tt.save_checkpoint(out_dir, state, i)
        rec = run_eval(i)
    elif args["force_final_eval"] == "1":
        rec = run_eval(i)
    else:
        rec = history[-1]
    logger.info("segment done at step %d: %s", i, json.dumps(rec))
    return rec


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
