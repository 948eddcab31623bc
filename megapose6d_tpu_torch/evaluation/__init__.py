"""Evaluation: BOP CSV bridge, meters, VSD, prediction/evaluation runners."""

from .bop import convert_results_to_bop, load_bop_results, run_bop_evaluation  # noqa: F401
from .meters import (  # noqa: F401
    BOPScoreMeter,
    Meter,
    ModelNetErrorMeter,
    compute_errors,
    compute_mssd_mspd,
    match_predictions,
    one_to_one_matching,
)
from .runner import EvaluationRunner, PredictionRunner, shard_frames  # noqa: F401
from .vsd import compute_vsd, vsd_recall  # noqa: F401
