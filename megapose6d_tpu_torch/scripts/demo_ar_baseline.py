"""BOP19 AR of the demo models on a synthetic BOP dataset, generated when it
is missing, with RGB-only poses and, with `depth_refine=icp|gnc`,
depth-refined ones, and with `detector_dir=` from a detector's boxes.

Counterpart of `megapose6d_tpu/scripts/demo_ar_baseline.py`: the same
dataset (`generate_bop` with the demo world, or `world=novel`'s textured
cylinder and cone, at f=400, 2 objects and 4 frames a scene, seed 123,
the realism or `domain=unlit` observations), the same models (coarse: 1
view; refiner: 2 views, `front_1view`), the same pipeline settings
(ground-truth or detector boxes, SO(3) grid, top-K, refiner iterations,
rescoring; 64 coarse images and 16 refiner hypotheses a chunk, 2
detections) and the same report. The evaluation reads the objects'
meshes from the dataset's `models/`, in a mesh database of 2048 faces,
512 points and 4 symmetries as the JAX script's. Weights come from npz
exports (`refiner_weights=`, `coarse_weights=`, `detector_weights=`; a
file name ending in `@<step>.npz` names the step in the report), or from a
seed.

    python -m megapose6d_tpu_torch.scripts.demo_ar_baseline out_dir=runs/ar_gnc \
        coarse_weights=build/weights/coarse_dr@5000.npz \
        refiner_weights=build/weights/refiner_dr@24000.npz \
        so3=64 refine_iters=3 n_hyp=4 depth_refine=icp report_dir=/tmp/ar [device=cpu]

writes `<report_dir>/report[_<domain>][_<world>][_<tag>].json`
(`report_dir` defaults to `out_dir`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from ..data.bop_scene_dataset import BOPDataset, load_bop_object_dataset
from ..data.tensor_collection import TensorCollection
from ..evaluation.evaluation import load_detector
from ..evaluation.meters import BOPScoreMeter
from ..evaluation.runner import EvaluationRunner, PredictionRunner
from ..inference.depth_refiner import GNCRegistrationRefiner, ICPRefiner
from ..inference.load_model import build_model, npz_step
from ..inference.pose_estimator import PoseEstimator
from ..inference.types import InferenceConfig
from ..meshes.mesh_db import BatchedMeshes, MeshDataBase
from ..meshes.worlds import build_bop_world
from ..models.pose_predictor import make_coarse_config, make_refiner_config
from ..ops._precision import pin_f32
from .generate_synthetic_dataset import generate_bop

logger = logging.getLogger(__name__)

DEFAULTS = dict(
    out_dir="ar_baseline", report_dir="", coarse_weights="", refiner_weights="", so3="576",
    refine_iters="3", backbone="resnet18-spatial", render="240,320", n_hyp="4", detector_dir="",
    detector_weights="", n_frames="24", depth_refine="0", dtype="auto", tag="",
    domain="realism", world="demo", device="cuda", seed="0",
)
DEPTH_REFINERS = {"1": ICPRefiner, "icp": ICPRefiner, "gnc": GNCRegistrationRefiner}


def parse_args(argv: list[str]) -> dict[str, str]:
    args = dict(DEFAULTS)
    for a in argv:
        k, _, v = a.partition("=")
        if k not in args:
            raise ValueError(f"unknown arg {k}")
        args[k] = v
    return args


def dataset_dir(args: dict[str, str]) -> Path:
    if args["domain"] not in ("realism", "unlit"):
        raise ValueError(args["domain"])
    name = ("synthdemo" if args["domain"] == "realism" else "synthdemo_unlit") + (
        "" if args["world"] == "demo" else f"_{args['world']}")
    return Path(args["out_dir"]) / name


def generate_dataset(args: dict[str, str], ds_dir: Path, device) -> Path:
    """The JAX script's dataset: `generate_bop` of the world at f=400, 2
    objects and 4 frames a scene, seed 123, at `render`."""
    mesh_db, objects = build_bop_world(args["world"], device)
    unlit = args["domain"] == "unlit"
    return generate_bop(mesh_db, objects, ds_dir, n_frames=int(args["n_frames"]),
                        resolution=tuple(int(x) for x in args["render"].split(",")), n_obj_per_scene=2, f=400.0,
                        frames_per_scene=4, seed=123, background=not unlit, unlit=unlit)


def world_mesh_db(ds_dir: Path, device) -> BatchedMeshes:
    """The dataset's objects as the demo world's mesh database."""
    objects = load_bop_object_dataset(ds_dir / "models")
    return MeshDataBase.from_object_ds(objects, max_faces=2048, n_points=512, n_sym=4).batched(device=device)


def _summary(scene_ds, mesh_db, final: TensorCollection, width: int) -> dict:
    out = EvaluationRunner(scene_ds, {"bop": BOPScoreMeter(mesh_db, image_width=width)}).evaluate(final)
    return {k: (float(v) if isinstance(v, (int, float, np.floating)) else v) for k, v in out["bop"].items()}


def run(args: dict[str, str]) -> tuple[dict, dict[str, TensorCollection]]:
    """(the report, final predictions of the RGB pass `rgb`, with a depth
    refiner of the depth-refined pass `depth`, and with a detector of the
    pass on its boxes `detector`)."""
    if args["depth_refine"] not in ("0", *DEPTH_REFINERS):
        raise ValueError(f"depth_refine must be 0, 1, icp or gnc, not {args['depth_refine']}")
    pin_f32()
    device = torch.device(args["device"])
    ds_dir = dataset_dir(args)
    if not (ds_dir / "test").exists():
        generate_dataset(args, ds_dir, device)
    render = tuple(int(x) for x in args["render"].split(","))
    dtype = args["dtype"] if args["dtype"] != "auto" else (
        "bfloat16" if device.type == "cuda" else "float32")
    mesh_db = world_mesh_db(ds_dir, device)
    scene_ds = BOPDataset(ds_dir, split="test", load_depth=True)
    logger.info("dataset: %d frames at %s", len(scene_ds), render)

    seed = int(args["seed"])
    refiner = build_model(None, args["refiner_weights"] or None, lambda render_size: make_refiner_config(
        backbone=args["backbone"], render_size=render_size, n_rendered_views=2,
        multiview_type="TCO+front_1view", compute_dtype=dtype), render, seed + 1, device)
    coarse = build_model(None, args["coarse_weights"] or None, lambda render_size: make_coarse_config(
        backbone=args["backbone"], render_size=render_size, compute_dtype=dtype), render, seed, device)
    r_step, c_step = npz_step(args["refiner_weights"]), npz_step(args["coarse_weights"])
    logger.info("weights: refiner@%d coarse@%d (0: seeded or unnamed)", r_step, c_step)

    cfg = InferenceConfig(
        SO3_grid_size=int(args["so3"]), n_refiner_iterations=int(args["refine_iters"]),
        n_pose_hypotheses=int(args["n_hyp"]), bsz_images=64, bsz_objects=16, max_detections=2,
    )
    width = scene_ds[0].rgb.shape[1]
    preds = {"rgb": PredictionRunner(scene_ds, PoseEstimator(coarse, refiner, mesh_db, cfg, device=device))
             .get_predictions()["final"]}
    logger.info("%d predictions", len(preds["rgb"]))
    summary = _summary(scene_ds, mesh_db, preds["rgb"], width)

    depth_summary = None
    method = {"1": "icp", "icp": "icp", "gnc": "gnc"}.get(args["depth_refine"])
    if method is not None:
        est = PoseEstimator(coarse, refiner, mesh_db, dataclasses.replace(cfg, run_depth_refiner=True),
                            device=device, depth_refiner=DEPTH_REFINERS[args["depth_refine"]](mesh_db))
        preds["depth"] = PredictionRunner(scene_ds, est).get_predictions()["final"]
        depth_summary = _summary(scene_ds, mesh_db, preds["depth"], width)
        logger.info("depth-refined summary: %s", depth_summary)
    det_summary = None
    if args["detector_dir"]:
        detector = load_detector(args["detector_dir"], args["detector_weights"] or None, device=device)
        preds["detector"] = PredictionRunner(
            scene_ds, PoseEstimator(coarse, refiner, mesh_db, cfg, device=device), detector=detector,
            detection_type="detector").get_predictions()["final"]
        logger.info("%d detector-driven predictions", len(preds["detector"]))
        if len(preds["detector"]):
            det_summary = _summary(scene_ds, mesh_db, preds["detector"], width)
    report = {
        "dataset": str(ds_dir), "domain": args["domain"], "world": args["world"],
        "n_frames": len(scene_ds), "refiner_step": r_step, "coarse_step": c_step,
        "so3_grid": int(args["so3"]), "refine_iters": int(args["refine_iters"]),
        "summary": summary, "detector_dir": args["detector_dir"] or None, "summary_from_detector": det_summary,
        "depth_refine_method": method, "summary_depth_refined": depth_summary,
    }
    return report, preds


def report_name(args: dict[str, str]) -> str:
    name = "report.json" if args["domain"] == "realism" else f"report_{args['domain']}.json"
    if args["world"] != "demo":
        name = name[:-5] + f"_{args['world']}.json"
    if args["tag"]:
        name = name[:-5] + f"_{args['tag']}.json"
    return name


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    report, _ = run(args)
    out = Path(args["report_dir"] or args["out_dir"]) / report_name(args)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2, default=str))
    logger.info("wrote %s", out)
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(main(), indent=2))
