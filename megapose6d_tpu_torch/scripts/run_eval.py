"""Evaluation CLI: one (dataset, detection, coarse) evaluation from an
`EvalConfig` set by `key=value` arguments (nested inference fields as
`inference.<field>=`).

    python -m megapose6d_tpu_torch.scripts.run_eval ds_name=synthdemo.bop19 \\
        data_dir=runs/ar_dr coarse_run=runs/coarse_dr refiner_run=runs/refiner_dr \\
        coarse_weights=build/weights/coarse_dr.npz refiner_weights=build/weights/refiner_dr.npz \\
        save_dir=eval_out load_depth=true inference.n_pose_hypotheses=4 device=cpu

Counterpart of `megapose6d_tpu/scripts/run_eval.py`, with its legacy
aliases (dataset=, out_dir=, so3_grid_size=, ...).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys

from ..evaluation.eval_config import EvalConfig, apply_eval_overrides
from ..evaluation.evaluation import run_eval

# Older CLI key -> configuration key.
LEGACY_KEYS = {
    "dataset": "ds_name",
    "out_dir": "save_dir",
    "so3_grid_size": "inference.SO3_grid_size",
    "n_refiner_iterations": "inference.n_refiner_iterations",
    "n_pose_hypotheses": "inference.n_pose_hypotheses",
    "max_detections": "inference.max_detections",
}


def normalize_argv(argv: list[str]) -> list[str]:
    out = []
    for a in argv:
        k, _, v = a.partition("=")
        k = LEGACY_KEYS.get(k, k)
        if k == "n_frames" and v in ("0", ""):
            continue  # "0 = all frames"
        if k == "load_depth":
            v = {"0": "false", "1": "true"}.get(v, v)
        out.append(f"{k}={v}")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = apply_eval_overrides(EvalConfig(), normalize_argv(argv))
    if cfg.save_dir is None:
        cfg = dataclasses.replace(cfg, save_dir="eval_out")
    out = run_eval(cfg)
    return out["summary"] if out else None


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(main(), indent=2))
