"""The evaluation entry point: one `EvalConfig` in; predictions, the BOP CSV
and the meters' summary out, under `get_save_dir(cfg)`.

Counterpart of `megapose6d_tpu/evaluation/evaluation.py`. Predictions are
saved in the JAX package's format, so either package reads the other's:
`results.npz` holds each stage's tensors under `<stage>::<tensor>` (with
`/` in stage names written `__`), `results.json` each stage's infos as a
pandas `to_json(orient="split")` string (here written and parsed without
pandas). `load_detector` rebuilds a detector run (`detection_type=
"detector"`).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.datasets_cfg import make_object_dataset, make_scene_dataset
from ..data.tensor_collection import TensorCollection
from ..inference.load_model import load_or_init_models, read_weights, weight_source
from ..interop.from_jax import detector_state_dict_from_jax
from ..interop.orbax import is_orbax_checkpoint
from ..inference.pose_estimator import PoseEstimator
from ..meshes.mesh_db import MeshDataBase
from ..models.detector import CenterNetDetector, Detector, DetectorConfig
from ..ops._precision import pin_f32
from .bop import convert_results_to_bop
from .eval_config import EvalConfig, get_save_dir
from .meters import BOPScoreMeter, ModelNetErrorMeter
from .runner import EvaluationRunner, PredictionRunner

logger = logging.getLogger(__name__)


def load_detector(run_dir: str | Path, detection_th: float = 0.7, weights: str | Path | None = None,
                  device: str | torch.device = "cuda") -> Detector:
    """A detector from its run directory's `labels.json` and `config.json`
    (without one, the default configuration with one class a label, as the
    JAX package reads its earliest runs), with the weights of `weights` (an
    npz export of a JAX run's params, an orbax checkpoint directory or a
    port checkpoint) if given, else of the run's checkpoint: a JAX run's
    `checkpoints/final` (orbax, as the JAX package's `load_detector` reads
    it), else the port run's latest (`run_detector_training`'s). A run
    without either raises. Detections at or above `detection_th`."""
    run_dir = Path(run_dir)
    labels = json.loads((run_dir / "labels.json").read_text())
    cfg_path = run_dir / "config.json"
    cfg = (DetectorConfig(**json.loads(cfg_path.read_text())) if cfg_path.exists()
           else DetectorConfig(n_classes=len(labels)))
    model = CenterNetDetector(cfg)
    final = run_dir / "checkpoints" / "final"
    source = weight_source(None, weights) if weights else (final if is_orbax_checkpoint(final)
                                                           else weight_source(run_dir, None))
    model.load_state_dict(read_weights(source, detector_state_dict_from_jax))
    return Detector(model.to(device), labels, detection_th)


def _json_value(x):
    """A numpy scalar as JSON: ints, floats (NaN as null), strings."""
    if isinstance(x, (np.integer, int)) and not isinstance(x, (bool, np.bool_)):
        return int(x)
    if isinstance(x, (np.floating, float)):
        return None if np.isnan(x) else float(x)
    if isinstance(x, (np.bool_, bool)):
        return bool(x)
    return str(x)


def infos_to_json(infos: dict[str, np.ndarray]) -> str:
    """Info columns as pandas' `DataFrame.to_json(orient="split")` lays
    them out (a range index)."""
    cols = list(infos)
    n = len(infos[cols[0]]) if cols else 0
    data = [[_json_value(infos[c][i]) for c in cols] for i in range(n)]
    return json.dumps({"columns": cols, "index": list(range(n)), "data": data})


def infos_from_json(text: str) -> dict[str, np.ndarray]:
    """The inverse of `infos_to_json`: integer columns int64, other
    numeric columns float64 (null as NaN), anything else strings."""
    d = json.loads(text)
    out = {}
    for j, col in enumerate(d["columns"]):
        vals = [row[j] for row in d["data"]]
        if vals and all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
            out[col] = np.asarray(vals, np.int64)
        elif vals and all(v is None or (isinstance(v, (int, float)) and not isinstance(v, bool)) for v in vals):
            out[col] = np.asarray([np.nan if v is None else v for v in vals], np.float64)
        else:
            out[col] = np.asarray(vals, dtype=object)
    return out


def save_predictions(preds: dict[str, TensorCollection], path: str | Path) -> Path:
    """`<path>.npz` + `<path>.json`, the JAX package's prediction bundle."""
    arrays: dict[str, np.ndarray] = {}
    infos: dict[str, str] = {}
    for key, tc in preds.items():
        safe = key.replace("/", "__")
        infos[safe] = infos_to_json(tc.infos)
        for name, t in tc.tensors.items():
            arrays[f"{safe}::{name}"] = t.cpu().numpy()
    np.savez_compressed(str(path) + ".npz", **arrays)
    Path(str(path) + ".json").write_text(json.dumps(infos))
    return Path(str(path) + ".npz")


def load_predictions(path: str | Path) -> dict[str, TensorCollection]:
    """Read a bundle written by `save_predictions` of either package."""
    path = str(path)
    if path.endswith(".npz"):
        path = path[: -len(".npz")]
    infos = json.loads(Path(path + ".json").read_text())
    out: dict[str, TensorCollection] = {}
    with np.load(path + ".npz") as arrays:
        for safe, infos_json in infos.items():
            tensors = {name.split("::", 1)[1]: torch.as_tensor(arrays[name])
                       for name in arrays.files if name.startswith(safe + "::")}
            out[safe.replace("__", "/")] = TensorCollection(infos=infos_from_json(infos_json), **tensors)
    return out


def run_eval(cfg: EvalConfig, scene_ds=None, object_ds=None) -> Optional[dict]:
    """Predict (unless `skip_inference`, which rescores the saved
    predictions), write the BOP CSV, and score the final poses (unless
    `skip_evaluation`). Returns {'results_path', 'pred_keys', 'save_dir',
    'summary'}."""
    pin_f32()
    save_dir = get_save_dir(cfg)
    save_dir.mkdir(parents=True, exist_ok=True)
    data_dir = cfg.data_dir or None
    if scene_ds is None:
        scene_ds = make_scene_dataset(cfg.ds_name, load_depth=cfg.load_depth, data_dir=data_dir)
    if object_ds is None:
        object_ds = make_object_dataset(cfg.ds_name, data_dir=data_dir)

    def score_and_save(final: TensorCollection, mesh_db) -> dict:
        summary: dict = {}
        if not cfg.skip_evaluation and len(final):
            w = scene_ds[0].rgb.shape[1] if len(scene_ds) else 640
            meters = {"modelnet": ModelNetErrorMeter(mesh_db), "bop": BOPScoreMeter(mesh_db, image_width=w)}
            summary = EvaluationRunner(scene_ds, meters).evaluate(final)
            (save_dir / "summary.json").write_text(json.dumps(summary, indent=2, default=str))
        return summary

    if cfg.skip_inference:
        results_path = save_dir / "results.npz"
        if not results_path.exists():
            raise FileNotFoundError(f"skip_inference=True but no saved predictions at {results_path}")
        preds = load_predictions(results_path)
        mesh_db = MeshDataBase.from_object_ds(object_ds, max_faces=cfg.max_faces).batched(device=cfg.device)
        return {"results_path": results_path, "pred_keys": list(preds), "save_dir": save_dir,
                "summary": score_and_save(preds["final"], mesh_db)}

    if cfg.inference.run_depth_refiner:
        # The JAX package's run_eval accepts this and runs no depth stage.
        raise ValueError("run_eval has no depth refiner; the depth-refined evaluation is "
                         "scripts/demo_ar_baseline.py depth_refine=icp|gnc")
    coarse, refiner, mesh_db = load_or_init_models(
        object_ds, cfg.coarse_run or None, cfg.refiner_run or None,
        render_size=tuple(cfg.render_size), max_faces=cfg.max_faces, coarse_weights=cfg.coarse_weights or None,
        refiner_weights=cfg.refiner_weights or None, device=cfg.device,
    )
    estimator = PoseEstimator(coarse, refiner, mesh_db, cfg.inference, device=cfg.device)
    detector = None
    if cfg.inference.detection_type == "detector":
        if not cfg.detector_run:
            raise ValueError("detection_type='detector' needs detector_run")
        detector = load_detector(cfg.detector_run, weights=cfg.detector_weights or None, device=cfg.device)
    runner = PredictionRunner(scene_ds, estimator, rank=cfg.rank, world_size=cfg.world_size, n_frames=cfg.n_frames,
                              detector=detector, detection_type=cfg.inference.detection_type)
    logger.info("[%s] predicting %d frames", cfg.ds_name, len(runner.frame_ids))
    preds = runner.get_predictions()
    results_path = save_predictions(preds, save_dir / "results")
    final = preds["final"]
    csv = convert_results_to_bop(final, save_dir / f"{cfg.ds_name.split('.')[0]}.csv")
    logger.info("wrote %s (%d predictions)", csv, len(final))
    return {"results_path": results_path, "pred_keys": list(preds), "save_dir": save_dir,
            "summary": score_and_save(final, mesh_db)}
