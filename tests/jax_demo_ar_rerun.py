"""The JAX package's own `demo_ar_baseline`, rerun at named checkpoint steps,
keeping its per-instance predictions.

`demo_ar_baseline` restores the step that a run's `checkpoints/latest.txt`
names, and writes only the summaries. This script gives it run directories
whose `latest.txt` names the requested step (the epoch directory is a
symbolic link to the committed one), points it at an existing dataset
(`synthdemo` is linked into the output directory, so nothing is generated),
and saves the final predictions of every pipeline pass it makes:

    python -m tests.jax_demo_ar_rerun <out_dir> depth_refine=icp \
        [refiner_step=24000] [coarse_step=5000] [dataset=runs/ar_gnc/synthdemo] \
        [so3=64] [refine_iters=3] [n_hyp=4]

writes `<out_dir>/report_<depth_refine>.json` (the script's own report)
and `<out_dir>/predictions_<depth_refine>.npz` with, per pass (`rgb`,
`depth`), `poses [N, 4, 4]`, `scene_id`, `view_id`, `label` and
`pose_score`. JAX runs on the CPU, in float32 (the script's `dtype=auto`).
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"

from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run_dir_at_step(src: Path, dst: Path, step: int) -> Path:
    """A run directory whose `latest.txt` names `step`, linking `src`'s
    config and its `epoch_<step>`."""
    ckpt = dst / "checkpoints"
    ckpt.mkdir(parents=True, exist_ok=True)
    link = ckpt / f"epoch_{step}"
    if not link.exists():
        link.symlink_to((src / "checkpoints" / f"epoch_{step}").resolve())
    (ckpt / "latest.txt").write_text(str(step))
    if not (dst / "config.json").exists():
        (dst / "config.json").symlink_to((src / "config.json").resolve())
    return dst


def main(argv: list[str]) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from megapose6d_tpu.scripts import demo_ar_baseline as demo

    out_dir = Path(argv[0])
    opts = dict(depth_refine="icp", refiner_step="24000", coarse_step="5000",
                dataset=str(ROOT / "runs/ar_gnc/synthdemo"), so3="64", refine_iters="3", n_hyp="4")
    for a in argv[1:]:
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k}")
        opts[k] = v
    out_dir.mkdir(parents=True, exist_ok=True)
    ds = out_dir / "synthdemo"
    if not ds.exists():
        ds.symlink_to(Path(opts["dataset"]).resolve())
    refiner = run_dir_at_step(ROOT / "runs/refiner_dr", out_dir / "refiner_dr", int(opts["refiner_step"]))
    coarse = run_dir_at_step(ROOT / "runs/coarse_dr", out_dir / "coarse_dr", int(opts["coarse_step"]))

    captured = []

    class CapturingRunner(demo.PredictionRunner):
        def get_predictions(self):
            preds = super().get_predictions()
            captured.append(preds["final"])
            return preds

    demo.PredictionRunner = CapturingRunner
    tag = opts["depth_refine"]
    report = demo.main([
        f"refiner_dir={refiner}", f"coarse_dir={coarse}", f"out_dir={out_dir}",
        f"so3={opts['so3']}", f"refine_iters={opts['refine_iters']}", f"n_hyp={opts['n_hyp']}",
        f"depth_refine={tag}", f"tag={tag}",
    ])
    arrays = {}
    for name, final in zip(("rgb", "depth"), captured):
        infos = final.infos
        arrays[f"{name}/poses"] = np.asarray(final.poses, np.float32)
        arrays[f"{name}/scene_id"] = infos["scene_id"].to_numpy().astype(np.int64)
        arrays[f"{name}/view_id"] = infos["view_id"].to_numpy().astype(np.int64)
        arrays[f"{name}/label"] = infos["label"].to_numpy().astype(str)
        arrays[f"{name}/pose_score"] = infos["pose_score"].to_numpy().astype(np.float32)
    np.savez(out_dir / f"predictions_{tag}.npz", **arrays)
    return report


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
