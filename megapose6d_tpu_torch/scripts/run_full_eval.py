"""Evaluation sweep: datasets x (detection type, coarse estimation type).

Counterpart of `megapose6d_tpu/scripts/run_full_eval.py`: for each dataset
of `ds_names` (empty: the seven BOP19 test sets, `BOP_TEST_DATASETS`) and
each pair of `detection_coarse_types`, one `run_eval`
under `<save_dir>/<ds_name>/<detection>+<coarse>/` with its
`eval_config.json`, and every summary in `<save_dir>/all_summaries.json`
keyed `<ds_name>/<detection>+<coarse>`, as the JAX package lays them out.
The port's meters score the BOP19 ARs in `run_eval`; with `run_bop_eval`,
bop_toolkit's `eval_bop19.py` (in `bop_toolkit_dir`, which the repository
does not hold) also scores each BOP19 dataset's results CSV, as in the JAX
package.

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

from ..evaluation.bop import run_bop_evaluation
from ..evaluation.eval_config import (
    BOP_TEST_DATASETS,
    BOPEvalConfig,
    EvalConfig,
    FullEvalConfig,
    apply_eval_overrides,
    generate_save_key,
    get_save_dir,
    save_eval_config,
)
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
    return generate_save_key(detection_type, coarse_estimation_type), eval_cfg


def run_full_eval(cfg: FullEvalConfig) -> dict:
    """Every evaluation of the sweep; returns (and writes) all summaries."""
    if not cfg.detection_coarse_types:
        raise ValueError("need detection_coarse_types")
    ds_names = cfg.ds_names or BOP_TEST_DATASETS
    if cfg.save_dir is None:
        raise ValueError("FullEvalConfig.save_dir is not set")
    all_summaries: dict[str, dict] = {}
    bop_eval_cfgs: list[BOPEvalConfig] = []
    for ds_name in ds_names:
        for det_type, coarse_type in cfg.detection_coarse_types:
            save_key, eval_cfg = create_eval_cfg(cfg, det_type, coarse_type, ds_name)
            if cfg.skip_inference:  # the saved results are only listed, as in the JAX package
                save_dir = get_save_dir(eval_cfg)
                eval_out = {"results_path": save_dir / "results.npz", "pred_keys": ["final"], "summary": {}}
                if not eval_out["results_path"].is_file():
                    raise FileNotFoundError(f"skip_inference=True but no results under {save_dir}")
            else:
                eval_out = run_eval(eval_cfg)
                save_dir = Path(eval_out["save_dir"])
            all_summaries[f"{ds_name}/{save_key}"] = eval_out["summary"]
            save_eval_config(eval_cfg, save_dir / "eval_config.json")
            if cfg.run_bop_eval and cfg.rank == 0 and "bop19" in ds_name:
                for method in sorted({"final", "depth_refiner"}.intersection(eval_out["pred_keys"])):
                    bop_eval_cfgs.append(BOPEvalConfig(results_path=str(eval_out["results_path"]), dataset=ds_name,
                                                       split="test", eval_dir=str(save_dir / "bop_evaluation"),
                                                       method=method))
    for bop_cfg in bop_eval_cfgs:  # the results CSV `run_eval` wrote beside results.npz
        csv = Path(bop_cfg.results_path).parent / f"{bop_cfg.dataset.split('.')[0]}.csv"
        result = run_bop_evaluation(csv, bop_cfg.eval_dir, bop_toolkit_dir=cfg.bop_toolkit_dir or None,
                                    dummy=cfg.debug)
        if result is not None:
            logger.info("bop_toolkit on %s: rc=%d", csv, result.returncode)
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
