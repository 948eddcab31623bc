"""The finalize demo: a trained refiner and coarse scorer through the full
coarse -> top-K -> refine -> rescore pipeline from ground-truth boxes on
held-out synthetic scenes, with A/Bs of the production options.

Counterpart of `megapose6d_tpu/scripts/demo_finalize_pipeline.py`, with
the same arguments and the same `report.json` keys:
  - refiner-only from noised ground truth (`init`, `refined`);
  - the full pipeline (`pipeline`);
  - the A/Bs against it: `lod_ab` (sweep and rescore on a 512-face
    database), `coarse_res_ab` (sweep renders at `coarse_render`),
    `coarse2_dir` (a second, natively smaller scorer), `prune_ab`
    (hierarchical `prune_grid` -> `prune_keep`) and `combo_ab` (pruning
    with the small scorer or the low-resolution sweep, and
    `combo_top_k`).

`refiner_dir`, `coarse_dir` and `coarse2_dir` are run directories, as
in the JAX script: the JAX package's (their orbax checkpoints) or the
port's (`demo_long_refiner`, `demo_long_coarse`), read at `epoch`,
`coarse_epoch` and `coarse2_epoch` (empty: the run's latest), with the
checkpoint's step in the report. `refiner_dir` and `coarse_dir` may also
name a weight file or checkpoint directory (an npz export of a JAX run's
params, ending in `@<step>.npz` to give the step). An empty `refiner_dir`
means weights from seed 1; an empty `coarse_dir` trains the scorer for
`coarse_steps` on the port's trainer. `coarse2_dir`'s `config.json`
gives the second scorer's model; `coarse2_weights=` overrides its run's
weights with a file. The evaluation scenes (`synthetic_batch_fn` at key
9999) and the pose noise (key 7) are drawn as the JAX script draws them
(`utils/threefry.py`) and rendered by the port. The report goes to
`<out_dir>/report.json`, by default under `build/`, so that a run never
overwrites the committed `runs/final_pipeline*` reports.

    python -m megapose6d_tpu_torch.scripts.demo_finalize_pipeline \\
        refiner_dir=runs/refiner_long coarse_dir=runs/coarse_grid out_dir=/tmp/final \\
        [epoch=14000] [coarse_epoch=2500] [so3=576] [n_eval=16] [lod_ab=1] \\
        [prune_ab=1 prune_grid=144 prune_keep=16] [coarse_res_ab=1] [coarse2_dir=runs/coarse120] \\
        [combo_ab=1 combo_top_k=2] [device=cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from ..data.types import ObservationTensor
from ..inference.load_model import build_model, weight_source, weights_step
from ..inference.pose_estimator import PoseEstimator
from ..inference.types import InferenceConfig, make_detections
from ..meshes.mesh_db import BatchedMeshes
from ..models.pose_predictor import PosePredictor, PosePredictorConfig
from ..ops._precision import pin_f32
from ..ops.se3 import add_pose_noise
from ..training import train as tt
from ..training.config import TrainingConfig, load_config, make_coarse_cfg, make_refiner_cfg
from ..training.forward_loss import BatchPoseData
from ..meshes.worlds import build_world
from .demo_synthetic_e2e import eval_draws, noise_draws, pose_errors, train_model

logger = logging.getLogger(__name__)
Tensor = torch.Tensor

DEFAULTS = dict(
    refiner_dir="runs/refiner_long", out_dir="build/final_pipeline",
    coarse_steps="800", epoch="", so3="576", n_eval="16",
    refine_iters="3", backbone="resnet18-spatial", render="240,320",
    batch_size="32", coarse_dir="", coarse_epoch="", lod_ab="0",
    prune_ab="0", prune_grid="72", prune_keep="8", top_k="4",
    dtype="auto", coarse_res_ab="0", coarse_render="120,160",
    coarse2_dir="", coarse2_epoch="", combo_ab="0", combo_top_k="",
    coarse2_weights="", device="cuda",
)


def parse_args(argv: list[str]) -> dict[str, str]:
    args = dict(DEFAULTS)
    for a in argv:
        k, _, v = a.partition("=")
        if k not in args:
            raise ValueError(f"unknown arg {k}")
        args[k] = v
    return args


def make_model(cfg: TrainingConfig, weights: str, epoch: str, seed: int,
               device: torch.device) -> tuple[PosePredictor, int]:
    """(the model of `cfg` with `weights`, the checkpoint's step): a run
    directory at `epoch` (empty: its latest), a weight file or checkpoint
    directory, or weights from `seed` when `weights` is empty."""
    source = weight_source(None, weights or None, epoch or None)
    model = build_model(None, source, lambda render_size: PosePredictorConfig(**cfg.model_config_kwargs()),
                        seed=seed, device=device)
    return model, weights_step(source)


@dataclasses.dataclass
class Models:
    refiner: PosePredictor
    coarse: PosePredictor
    coarse2: PosePredictor | None
    refiner_step: int
    coarse2_step: int


def build_models(args: dict[str, str], mesh_db: BatchedMeshes, input_res: tuple[int, int], dtype: str) -> Models:
    """The refiner and coarse scorer of the JAX script's configurations
    (and the second scorer of `coarse2_dir`), weights loaded, on the DB's
    device."""
    device = mesh_db.device
    base = TrainingConfig(
        input_resize=input_res, render_size=input_res, batch_size=int(args["batch_size"]),
        backbone_str=args["backbone"], compute_dtype=dtype, n_points_loss=256, lr=3e-4,
        n_epochs_warmup=200, lr_epoch_decay=10**6, epoch_size=int(args["batch_size"]), seed=0,
    )
    ref_cfg = dataclasses.replace(make_refiner_cfg(base), n_rendered_views=2,
                                  multiview_type="front_1view", n_iterations=1)
    refiner, refiner_step = make_model(ref_cfg, args["refiner_dir"], args["epoch"], 1, device)
    logger.info("refiner weights @ step %d", refiner_step)
    coarse_cfg = dataclasses.replace(make_coarse_cfg(base), n_hypotheses=4)
    if args["coarse_dir"]:
        coarse, coarse_step = make_model(coarse_cfg, args["coarse_dir"], args["coarse_epoch"], 0, device)
        logger.info("coarse weights @ step %d", coarse_step)
    else:
        coarse = train_model(coarse_cfg, mesh_db, int(args["coarse_steps"]), input_res, "coarse")[0]
    coarse2, coarse2_step = None, 0
    if args["coarse2_dir"]:
        cfg2 = dataclasses.replace(load_config(Path(args["coarse2_dir"]) / "config.json"), compute_dtype=dtype)
        coarse2, coarse2_step = make_model(cfg2, args["coarse2_weights"] or args["coarse2_dir"],
                                           "" if args["coarse2_weights"] else args["coarse2_epoch"], 2, device)
        logger.info("small coarse scorer %s @ step %d", tuple(cfg2.render_size), coarse2_step)
    return Models(refiner, coarse, coarse2, refiner_step, coarse2_step)


def _median_mm(x) -> float:
    return float(np.median(np.asarray(x)) * 1000)


@torch.no_grad()
def evaluate(args: dict[str, str], mesh_db: BatchedMeshes, models: Models, batch: BatchPoseData,
             noise: tuple[Tensor, Tensor]) -> dict:
    """The report, from the evaluation `batch` (the first `n_eval` scenes
    go through the pipeline) and the noise normals of its poses."""
    device = mesh_db.device
    n_eval, n_it = int(args["n_eval"]), int(args["refine_iters"])
    refiner, coarse, coarse2 = models.refiner, models.coarse, models.coarse2
    meshes = mesh_db.select(batch.mesh_idx)
    pts = meshes.points[:, :256]

    # (a/b) refiner-only from noised ground truth.
    TCO_init = add_pose_noise(batch.TCO, euler_deg_std=(15, 15, 15), trans_std=(0.01, 0.01, 0.05),
                              euler_normals=noise[0].to(device), trans_normals=noise[1].to(device))
    TCO_ref = TCO_init
    for _ in range(n_it):
        TCO_ref = refiner.refine_step(batch.rgbs, batch.K, TCO_ref, meshes)["TCO_output"]
    add0, rot0, tr0 = (x.cpu().numpy() for x in pose_errors(TCO_init, batch.TCO, pts))
    add1, rot1, tr1 = (x.cpu().numpy() for x in pose_errors(TCO_ref, batch.TCO, pts))

    # (c) the full pipeline from ground-truth boxes.
    icfg = InferenceConfig(
        SO3_grid_size=int(args["so3"]), n_refiner_iterations=n_it, n_pose_hypotheses=int(args["top_k"]),
        bsz_images=64, bsz_objects=16, max_detections=1,
    )
    labels = list(mesh_db.labels)

    def estimator(model=coarse, cfg=icfg, **kw) -> PoseEstimator:
        return PoseEstimator(model, refiner, mesh_db, cfg, device=device, **kw)

    def run_pipeline_eval(est: PoseEstimator, tag: str):
        add_l, rot_l, tr_l, poses_l = [], [], [], []
        for i in range(n_eval):
            obs = ObservationTensor(batch.rgbs[i : i + 1], batch.K[i : i + 1])
            det = make_detections([labels[int(batch.mesh_idx[i])]], batch.bboxes[i : i + 1].cpu().numpy(),
                                  device=device)
            data, _ = est.run_inference_pipeline(obs, det)
            a, r, t = (float(x[0]) for x in pose_errors(data.poses, batch.TCO[i : i + 1], pts[i : i + 1]))
            add_l.append(a)
            rot_l.append(r)
            tr_l.append(t)
            poses_l.append(data.poses[0].cpu().numpy())
            logger.info("pipeline[%s] %d/%d: ADD %.1f mm, rot %.1f deg, trans %.1f mm",
                        tag, i + 1, n_eval, a * 1000, r, t * 1000)
        return add_l, rot_l, tr_l, poses_l

    pipe_add, pipe_rot, pipe_tr, pipe_poses = run_pipeline_eval(estimator(), "full")

    def ab_report(est: PoseEstimator, tag: str, **extra) -> dict:
        """Top-1 agreement and error medians of `est` against the full run."""
        a_add, a_rot, _, a_poses = run_pipeline_eval(est, tag)
        same = [float(np.allclose(a, b, atol=1e-5)) for a, b in zip(pipe_poses, a_poses)]
        rep = {
            "top1_pose_agreement_frac": float(np.mean(same)),
            "add_mm_full": _median_mm(pipe_add),
            f"add_mm_{tag}": _median_mm(a_add),
            "rot_deg_full": float(np.median(pipe_rot)),
            f"rot_deg_{tag}": float(np.median(a_rot)),
            "add_mm_worst_frame_delta": float(np.max(np.asarray(a_add) - np.asarray(pipe_add)) * 1000),
            **extra,
        }
        logger.info("%s A/B: %s", tag, json.dumps(rep))
        return rep

    c_res = tuple(int(x) for x in args["coarse_render"].split(","))
    prune = dict(SO3_prune_grid_size=int(args["prune_grid"]), SO3_prune_keep=int(args["prune_keep"]))
    reports: dict[str, dict | None] = dict.fromkeys(("lod_ab", "prune_ab", "coarse_res_ab", "coarse_small_ab",
                                                     "combo_ab"))
    if args["lod_ab"] == "1":
        lod = build_world(max_faces=512, device=device)
        reports["lod_ab"] = ab_report(estimator(mesh_db_coarse=lod), "lod",
                                      coarse_lod_faces=int(lod.faces.shape[1]))
    if args["coarse_res_ab"] == "1":
        reports["coarse_res_ab"] = ab_report(
            estimator(cfg=dataclasses.replace(icfg, coarse_render_size=c_res)), "coarse_res",
            coarse_render_size=list(c_res))
    if coarse2 is not None:
        reports["coarse_small_ab"] = ab_report(
            estimator(model=coarse2), "coarse_small", coarse_input_size=list(coarse2.cfg.render_size),
            coarse2_dir=args["coarse2_dir"], coarse2_step=models.coarse2_step)
    if args["prune_ab"] == "1":
        reports["prune_ab"] = ab_report(estimator(cfg=dataclasses.replace(icfg, **prune)), "pruned",
                                        prune_grid=prune["SO3_prune_grid_size"],
                                        prune_keep=prune["SO3_prune_keep"])
    if args["combo_ab"] == "1":
        combo_cfg = dataclasses.replace(icfg, **prune, coarse_render_size=None if coarse2 is not None else c_res)
        if args["combo_top_k"]:
            combo_cfg = dataclasses.replace(combo_cfg, n_pose_hypotheses=int(args["combo_top_k"]))
        reports["combo_ab"] = ab_report(
            estimator(model=coarse2 if coarse2 is not None else coarse, cfg=combo_cfg), "combo",
            prune_grid=prune["SO3_prune_grid_size"], prune_keep=prune["SO3_prune_keep"],
            coarse_small=coarse2 is not None,
            **({"top_k": int(args["combo_top_k"])} if args["combo_top_k"] else {}),
            coarse_render_size=None if coarse2 is not None else list(c_res))

    diam = float(mesh_db.diameters.mean())
    return {
        "refiner_checkpoint_step": models.refiner_step,
        "refine_iters": n_it,
        "init": {"add_mm": _median_mm(add0), "rot_deg": float(np.median(rot0)), "trans_mm": _median_mm(tr0)},
        "refined": {
            "add_mm": _median_mm(add1), "rot_deg": float(np.median(rot1)), "trans_mm": _median_mm(tr1),
            "rot_improved_frac": float((rot1 < rot0).mean()), "add_improved_frac": float((add1 < add0).mean()),
        },
        "pipeline": {
            "add_mm": _median_mm(pipe_add), "rot_deg": float(np.median(pipe_rot)), "trans_mm": _median_mm(pipe_tr),
            "add_below_0.1d_frac": float((np.asarray(pipe_add) < 0.1 * diam).mean()),
        },
        "mean_diameter_m": diam,
        "so3_grid": int(args["so3"]),
        "coarse_dir": args["coarse_dir"] or None,
        **reports,
    }


def run(args: dict[str, str]) -> dict:
    """Build the world and the models, draw and render the evaluation
    scenes, evaluate."""
    pin_f32()
    device = torch.device(args["device"])
    input_res = tuple(int(x) for x in args["render"].split(","))
    dtype = args["dtype"] if args["dtype"] != "auto" else ("bfloat16" if device.type == "cuda" else "float32")
    mesh_db = build_world(device=device)
    models = build_models(args, mesh_db, input_res, dtype)
    B = max(int(args["n_eval"]), 16)
    synth = tt.synthetic_batch_fn(mesh_db, B, input_res, f=400.0, device=device)
    batch = synth.make({k: v.to(device) for k, v in eval_draws(len(mesh_db.labels), B).items()})
    return evaluate(args, mesh_db, models, batch, noise_draws(B))


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    report = run(args)
    out_dir = Path(args["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    logger.info("%s", json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
