"""Long-schedule refiner training with held-out evaluation.

Counterpart of `megapose6d_tpu/scripts/demo_long_refiner.py`: the
synthetic-world refiner (2 views, front_1view, one iteration) trained at a
long schedule on the port's trainer, its rotation, translation and ADD
errors on held-out scenes (noised ground truth -> `refine_iters`
iterations) every `eval_every` steps into `history.json`, checkpoints
(`torch.save`, `checkpoints/epoch_<step>/state.pt`) every `ckpt_every`, and
`report.json` at the end. Run again on the same `out_dir`, it resumes from
the latest checkpoint; `max_seconds` bounds one segment. Each step's batch
and draws come from (seed, step), so a resumed run repeats an unbroken
one. The port compiles no program per shape, so the JAX script's
persistent compilation cache has no counterpart. `demo_finalize_pipeline
refiner_dir=<out_dir>` consumes the run.

    python -m megapose6d_tpu_torch.scripts.demo_long_refiner out_dir=runs/refiner_long \\
        n_steps=60000 [batch_size=32] [eval_every=4000] [backbone=resnet18-spatial] [device=cpu]
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
from ..training import train as tt
from ..training.config import TrainingConfig, make_refiner_cfg, save_config
from .demo_synthetic_e2e import eval_set, pose_errors, refine_n

logger = logging.getLogger(__name__)

DEFAULTS = dict(
    out_dir="demo_long", n_steps="60000", batch_size="32", eval_every="4000", ckpt_every="8000",
    backbone="resnet18-spatial", render="240,320", lr="3e-4", lr_decay_step="45000", seed="0",
    refine_iters="3", n_eval="64", max_seconds="1e9",
    # domain_rand=1: randomized lighting and procedural backgrounds in the
    # training observations (the evaluation stays on the unlit set).
    domain_rand="0",
    # occlude=1: a second random object composited in front of the target.
    occlude="0",
    device="cuda",
)


def parse_args(argv: list[str], defaults: dict[str, str]) -> dict[str, str]:
    args = dict(defaults)
    for a in argv:
        k, _, v = a.partition("=")
        if k not in args:
            raise ValueError(f"unknown arg {k}")
        args[k] = v
    return args


def train_steps(state: tt.TrainState, cfg: TrainingConfig, synth, mesh_db, start: int, n_steps: int,
                max_seconds: float, on_step) -> int:
    """Steps `start`.. until `n_steps` or `max_seconds`, each with the batch
    and draws of its index; `on_step(i, metrics, t0)` after each. Returns
    the last step done."""
    t0 = time.monotonic()
    i = start
    while i < n_steps and (time.monotonic() - t0) < max_seconds:
        batch = synth(tt.step_generator(cfg.seed, tt.BATCH_STREAM, i))
        draws = tt.step_draws(cfg, batch, mesh_db, tt.DRAW_STREAM, i)
        metrics = tt.train_step(state, cfg, batch, mesh_db, draws, cfg.n_iterations)
        i += 1
        on_step(i, metrics, t0)
    return i


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv, DEFAULTS)
    pin_f32()
    out_dir = Path(args["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    input_res = tuple(int(x) for x in args["render"].split(","))
    n_steps, eval_every, ckpt_every = int(args["n_steps"]), int(args["eval_every"]), int(args["ckpt_every"])
    device = torch.device(args["device"])
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    mesh_db = build_world(device=device)
    logger.info("world: %s; device %s", mesh_db.labels, device)

    base = TrainingConfig(
        input_resize=input_res, render_size=input_res, batch_size=int(args["batch_size"]),
        backbone_str=args["backbone"], compute_dtype=dtype, n_points_loss=256, lr=float(args["lr"]),
        n_epochs_warmup=200,  # an epoch is one step here (epoch_size == batch_size)
        lr_epoch_decay=int(args["lr_decay_step"]), epoch_size=int(args["batch_size"]), seed=int(args["seed"]),
    )
    cfg = dataclasses.replace(make_refiner_cfg(base), n_rendered_views=2, multiview_type="front_1view",
                              n_iterations=1)
    save_config(cfg, out_dir / "config.json")  # the run directory serves run_eval and build_model
    state = tt.create_train_state(cfg, device=device)
    start_step = 0
    if (out_dir / "checkpoints" / "latest.txt").exists():
        state, start_step = tt.load_checkpoint(out_dir, state)
        logger.info("resumed from step %d", start_step)
    synth = tt.synthetic_batch_fn(mesh_db, cfg.batch_size, input_res, f=400.0,
                                  domain_rand=args["domain_rand"] == "1", occlude=args["occlude"] == "1",
                                  device=device)

    # The held-out set, fixed across the run.
    batch, TCO_init = eval_set(mesh_db, int(args["n_eval"]), input_res)
    meshes = mesh_db.select(batch.mesh_idx)
    pts = meshes.points[:, :256]
    n_it = int(args["refine_iters"])
    add0, rot0, tr0 = (x.cpu().numpy() for x in pose_errors(TCO_init, batch.TCO, pts))
    history_path = out_dir / "history.json"
    history = json.loads(history_path.read_text()) if history_path.exists() else []
    # On resume, drop the records past the restored checkpoint: those steps run again.
    history = [r for r in history if r["step"] <= start_step]

    def run_eval(step: int) -> dict:
        TCO_ref = refine_n(state.model, batch, meshes, TCO_init, n_it)
        add1, rot1, tr1 = (x.cpu().numpy() for x in pose_errors(TCO_ref, batch.TCO, pts))
        rec = {
            "step": step,
            "rot_init_deg": float(np.median(rot0)), "rot_refined_deg": float(np.median(rot1)),
            "trans_init_mm": float(np.median(tr0) * 1000), "trans_refined_mm": float(np.median(tr1) * 1000),
            "add_init_mm": float(np.median(add0) * 1000), "add_refined_mm": float(np.median(add1) * 1000),
            "rot_improved_frac": float((rot1 < rot0).mean()),
        }
        history.append(rec)
        history_path.write_text(json.dumps(history, indent=1))
        logger.info("[eval @ %d] rot %.2f->%.2f deg (improved %.0f%%) | trans %.1f->%.1f mm | ADD %.1f->%.1f mm",
                    step, rec["rot_init_deg"], rec["rot_refined_deg"], 100 * rec["rot_improved_frac"],
                    rec["trans_init_mm"], rec["trans_refined_mm"], rec["add_init_mm"], rec["add_refined_mm"])
        return rec

    def on_step(i: int, metrics: dict, t0: float) -> None:
        if i % 500 == 0 or i == start_step + 1:
            logger.info("step %d/%d loss=%.4f orn=%.4f xy=%.4f z=%.4f (%.2fs/step)", i, n_steps,
                        metrics["loss_total"], metrics.get("loss_TCO-loss_orn", -1),
                        metrics.get("loss_TCO-loss_xy", -1), metrics.get("loss_TCO-loss_z", -1),
                        (time.monotonic() - t0) / (i - start_step))
        if i % eval_every == 0:
            run_eval(i)
        if i % ckpt_every == 0:
            tt.save_checkpoint(out_dir, state, i)

    i = train_steps(state, cfg, synth, mesh_db, start_step, n_steps, float(args["max_seconds"]), on_step)
    # No trailing evaluation and checkpoint when they would repeat the last
    # record (no step run, or the loop ended on an evaluation step).
    if not history or history[-1]["step"] != i:
        rec = run_eval(i)
        tt.save_checkpoint(out_dir, state, i)
    else:
        rec = history[-1]
    (out_dir / "report.json").write_text(json.dumps({"final": rec, "history": history, "config": {
        "backbone": args["backbone"], "n_steps": n_steps, "batch_size": cfg.batch_size, "render": list(input_res),
    }}, indent=1))
    logger.info("%s", json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
