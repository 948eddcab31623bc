"""Evaluation sweep: datasets x (detection type, coarse estimation type).

Counterpart of `megapose6d_tpu/scripts/run_full_eval.py`: for each dataset
of `ds_names` and each pair of `detection_coarse_types`, one `run_eval`
under `<save_dir>/<ds_name>/<detection>+<coarse>/` with its
`eval_config.json`, and every summary in `<save_dir>/all_summaries.json`
keyed `<ds_name>/<detection>+<coarse>`, as the JAX package lays them out.
The official bop_toolkit scoring (`run_bop_eval`) is not ported: the
port's meters score the BOP19 ARs in `run_eval`.

    python -m megapose6d_tpu_torch.scripts.run_full_eval ds_names=synthdemo.bop19 \\
        data_dir=runs/ar_dr save_dir=build/full_eval detection_coarse_types=gt:SO3_grid,detector:SO3_grid \\
        coarse_run=runs/coarse_dr refiner_run=runs/refiner_dr detector_run=runs/detector_long \\
        [coarse_weights=... refiner_weights=... detector_weights=...] load_depth=true [device=cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
from pathlib import Path

from ..evaluation.eval_config import EvalConfig, FullEvalConfig, apply_eval_overrides, get_save_dir, save_eval_config
from ..evaluation.evaluation import run_eval
from .run_eval import normalize_argv

logger = logging.getLogger(__name__)


def create_eval_cfg(cfg: FullEvalConfig, detection_type: str, coarse_estimation_type: str,
                    ds_name: str) -> tuple[str, EvalConfig]:
    """(save key `<detection>+<coarse>`, the evaluation of one pair on one
    dataset)."""
    inference = dataclasses.replace(cfg.inference, detection_type=detection_type,
                                    coarse_estimation_type=coarse_estimation_type)
    fields = {f.name for f in dataclasses.fields(EvalConfig)} - {"inference"}
    eval_cfg = EvalConfig(**{k: getattr(cfg, k) for k in fields}, inference=inference)
    eval_cfg = dataclasses.replace(eval_cfg, ds_name=ds_name)
    if detection_type == "detector" and not eval_cfg.detector_run:
        raise ValueError("the detector detection type needs detector_run")
    return f"{detection_type}+{coarse_estimation_type}", eval_cfg


def run_full_eval(cfg: FullEvalConfig) -> dict:
    """Every evaluation of the sweep; returns (and writes) all summaries."""
    if not cfg.detection_coarse_types:
        raise ValueError("need detection_coarse_types")
    if not cfg.ds_names:
        raise ValueError("need ds_names (the BOP test datasets are not ported)")
    if cfg.save_dir is None:
        raise ValueError("FullEvalConfig.save_dir is not set")
    all_summaries: dict[str, dict] = {}
    for ds_name in cfg.ds_names:
        for det_type, coarse_type in cfg.detection_coarse_types:
            save_key, eval_cfg = create_eval_cfg(cfg, det_type, coarse_type, ds_name)
            if cfg.skip_inference:  # the saved results are only listed, as in the JAX package
                save_dir, summary = get_save_dir(eval_cfg), {}
                if not (save_dir / "results.npz").is_file():
                    raise FileNotFoundError(f"skip_inference=True but no results under {save_dir}")
            else:
                eval_out = run_eval(eval_cfg)
                save_dir, summary = Path(eval_out["save_dir"]), eval_out["summary"]
            all_summaries[f"{ds_name}/{save_key}"] = summary
            save_eval_config(eval_cfg, save_dir / "eval_config.json")
    out_dir = Path(cfg.save_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "all_summaries.json").write_text(json.dumps(all_summaries, indent=2, default=str))
    logger.info("wrote %s", out_dir / "all_summaries.json")
    return all_summaries


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    cfg = apply_eval_overrides(FullEvalConfig(), normalize_argv(argv))
    if cfg.save_dir is None:
        cfg = dataclasses.replace(cfg, save_dir="full_eval")
    return run_full_eval(cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(main(), indent=2))
