"""Smoke run of megapose6d_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its wall time:
  1. device: the card's name and power limit;
  2. build: the visibility kernel (csrc/visibility.cu) with nvcc, its
     registers and spills, and the shared loads of its loops (SASS);
  3. kernel vs plain: renders of a cube, a UV sphere and a BOP model at
     240x320 for 64 poses, through the kernel and its plain torch twin;
  4. pipeline: the full RGB pipeline (576-rotation coarse grid, 5
     hypotheses, 5 refiner iterations, resnet18-spatial in bf16 at
     240x320, weights from a seed, textured models) on 3 committed frames
     of runs/ar_baseline/synthdemo (decoded by the port's PNG reader,
     boxes from scene_gt_info.json), with the kernel's launches counted;
  5. cross-check: the pipeline's phases at a small size on the GPU against
     the same models on the CPU (plain phase B), in f32;
  6. kernel timing at the shapes of every render of one request (coarse
     sweep, refiner, rescore), each launch held bit for bit against the
     plain twin; per phase the kernel's and the plain twin's times and the
     bound, and the kernel's sum per request; at the coarse shape also the
     store floor (the same tables with no active chunk) and the share of
     face evaluations the kernel's cull leaves; per phase the active tiles
     per image and the active chunks per tile;
  7. profile: one more request under torch.profiler: the device's busy
     share of the request's wall time and the kernels with the most device
     time;
  8. eval rescore: the JAX package's committed predictions
     (runs/full_eval/synthdemo.bop19/gt+SO3_grid) read by the port and
     scored by its meters on the GPU against runs/ar_dr/synthdemo with
     depth, every VSD distance map rendered through the kernel; the ARs
     held to the committed summary.json, the first frame's VSD launches
     held bit for bit against the plain twin, the kernel timed at the VSD
     shape, beside its store floor, and its time per launch against the
     chunks of the launch's longest tile;
  9. eval run: the port's run_eval (gt detections, grid 576, K=4, 3
     refiner iterations, 2 detections, as the committed eval_config.json)
     on the first 8 frames with seeded weights, or on all 56 frames with
     the trained weights when build/weights/coarse_dr@5000.npz and
     refiner_dr@24000.npz exist (written by `python -m
     tests.test_torch_checkpoints export <run> <npz> <step>` where the JAX
     package is installed); with the trained
     weights also the same frames with the models in f32, and each of the
     two runs against the other and against the committed JAX predictions,
     per instance;
 10. depth refiners: ICPRefiner and GNCRegistrationRefiner on frames of
     runs/ar_gnc/synthdemo at ground-truth poses perturbed from a seed, on
     the GPU and on the CPU (plain phase B), poses held to each other; each
     refiner's depth render (B = the frame's objects, 120x160) held bit for
     bit against the plain twin and timed, beside each refiner's time per
     frame and the parts that should set it (the ICP distance passes and
     6x6 solves, GNC's batched 3x3 SVDs);
 11. rgbd: load_named_model("megapose-1.0-RGBD") and
     ("megapose-1.0-RGB-multi-hypothesis-icp") at full width (resnet34,
     240x320, grid 576, bf16, seeded weights), two requests each on an
     ar_gnc frame with its measured depth, per-phase seconds and launches;
 12. depth eval: the ported demo_ar_baseline on runs/ar_gnc/synthdemo (10
     frames, grid 64, 3 iterations, K=4, 2 detections) with ICP and with
     GNC: RGB, ICP and GNC AR beside the committed reports; with
     build/weights/coarse_dr@5000.npz and refiner_dr@24000.npz in f32 (as
     the committed reports, made on a CPU) and in bf16, each pass held per
     instance against the JAX package's own rerun at those steps on a CPU
     when build/jax_ar_gnc/predictions_{icp,gnc}.npz are in the copy
     (written by `python -m tests.jax_demo_ar_rerun`); seeded in bf16
     otherwise;
 13. training: `run_training synthetic=1` with runs/refiner_dr's settings
     (resnet18-spatial, 240x320, batch 32, bf16, 2 views, 1 iteration,
     weights from a seed) for 10 epochs of one step, a checkpoint, 2 more
     resumed, and with runs/coarse_dr's (the grid objective, 4 hypotheses)
     for 5, the kernel's launches counted; per configuration the step's
     seconds by part (batch synthesis, forward, backward, optimizer; CUDA
     events), the traced idle share of a step and the peak memory; the
     kernel at the training launch shapes (observations B=32, refiner
     hypotheses B=64, coarse hypotheses B=128) held bit for bit against
     the plain twin and timed beside the bound; one f32 refiner step
     through the kernel against one through the plain twin (deterministic
     cuDNN; loss and gradient norm to 1e-6 relative); forward_loss and its
     gradients on the card against the CPU at the CPU tests' size; 40
     overfit steps on one batch, whose loss must fall;
 14. production: the JAX bench's headline request (the host-made disc at
     480x640, 8 boxes of obj1; the bench world's 3200-face database and
     768-face LOD database) through the JAX package's production
     configuration: runs/coarse120's scorer (120x160 native, bf16), the
     576 grid pruned 144 -> 16, top-2, 5 iterations of runs/refiner_dr's
     refiner, 192/16 chunks, fused and captured into a CUDA graph
     (weights from build/weights when there, else seeded): the capture
     request's and the replayed requests' seconds, K1 launches per request
     (recorded in the graph, launched again by every replay), K1 at each
     of the request's launch shapes bit for bit against the plain twin
     and timed beside the bound, the replay bit for bit against an eager
     run of the same function, the traced idle share of a replayed and of
     a phased request, fused against phased poses, and one request each
     of the unpruned sweep, `coarse_render_size=(120,160)` with
     runs/coarse_dr's scorer, `rescore_f32`, `keep_all_coarse_outputs`
     and external initial poses;
 15. demo finalize: the ported demo_finalize_pipeline (grid 576, 3
     iterations, top-4, the lod, coarse_res, coarse120, prune 144/16 and
     combo top-2 A/Bs) with build/weights/refiner_long@14000.npz,
     coarse_grid@2500.npz and coarse120@3000.npz when all three are there
     (32 scenes, as the committed reports; each number printed beside
     runs/final_pipeline*/report.json), seeded on 16 scenes otherwise;
     every report number finite;
 16. scene generation: demo_ar_baseline's dataset (56 frames, the demo
     world, 240x320, f=400, 2 objects, 4 frames a scene, seed 123, realism)
     regenerated by the port's generate_bop into build/, frame by frame
     against the committed runs/ar_dr/synthdemo (instances, scene_gt and
     scene_camera, rgb and depth beyond one level or mm, mask_visib IoU)
     and, when build/jax_synthdemo holds the JAX package's CPU frames of
     the same set, against those; generate at its defaults (480x640, 3
     objects, f=600) into one webdataset shard, read back; K1 at both
     generators' main and shadow passes bit for bit and timed; seconds
     per frame and launches;
 17. detector: runs/detector_long's configuration (with
     build/weights/detector_long@12000.npz when there, else seeded) on 4
     committed frames, card against CPU per head; run_detector_training
     (demo world, masks, batch 16) for 20 steps and the same run resumed
     from its step-10 checkpoint, equal bit for bit (deterministic
     cuDNN); the step by part (render, forward, backward, Adam; CUDA
     events) and its traced idle share; K1 at the batch's shapes (B=32
     per pass); evaluate_detector (40 batches beside
     runs/detector_long/eval.json with the npz, else 4, finite);
 18. detector serving: one run_inference_pipeline(run_detector=True)
     request on a committed frame with runs/coarse_dr and runs/refiner_dr,
     phased with per-phase seconds (the detector's included), then fused
     (the detector before the CUDA graph), fused against phased; two
     detector calls bit for bit (deterministic cuDNN in `Detector.infer`)
     and the detector's forward timed with and without it; with the three
     exports and build/jax_det_eval_f32 (the JAX package's float32
     run_eval of 4 frames on a CPU), the same frames in float32 on the
     card against it, per detection and per instance;
     run_full_eval as runs/full_eval/synthdemo.bop19/detector+SO3_grid
     (all 56 frames with the three npz exports, each detection against
     the committed results.npz and the summary beside summary.json; 8
     frames seeded); demo_ar_baseline detector_dir= (runs/ar_dr beside its
     report.json with the exports; runs/ar_gnc seeded);
 19. dataset training: run_training train_datasets=synthdemo.bop19
     data_dir=runs/ar_dr at runs/refiner_dr's width with 4 loader workers
     (20 steps), at runs/coarse_dr's (5), and on phase 16's webdataset
     shard with the generator's objects as a `dir:` models directory (5),
     K1's launches counted; the refiner with the inline loader and
     deterministic cuDNN, resumed from step 4, bit for bit the unbroken
     6-step run; each configuration's step from the loader by part (the
     host's wait, H2D, forward, backward, Adam) and a traced step's idle
     share; the loader alone with 4 workers and inline; which decoder
     ran; one batch through a refiner step on the card and the CPU, stage
     by stage; K1 at the path's launch shapes (refiner B=64, coarse
     B=128) bit for bit and timed; run_eval of the trained runs on 2
     frames, read from their checkpoints.
The line before the last is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`. Any failure raises and exits nonzero.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from megapose6d_tpu_torch.data.bop_scene_dataset import BOPDataset
from megapose6d_tpu_torch.data.datasets_cfg import make_object_dataset, make_scene_dataset
from megapose6d_tpu_torch.data.types import ObservationTensor
from megapose6d_tpu_torch.evaluation.eval_config import EvalConfig, get_save_dir
from megapose6d_tpu_torch.evaluation.evaluation import load_predictions, run_eval
from megapose6d_tpu_torch.evaluation.meters import BOPScoreMeter
from megapose6d_tpu_torch.evaluation.runner import EvaluationRunner
from megapose6d_tpu_torch.evaluation.vsd import BOP19_THRESHOLDS
from megapose6d_tpu_torch.data.tensor_collection import TensorCollection
from megapose6d_tpu_torch.inference.depth_refiner import GNCRegistrationRefiner, ICPRefiner
from megapose6d_tpu_torch.inference.load_model import build_model, load_named_model
from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
from megapose6d_tpu_torch.inference.types import InferenceConfig, make_detections
from megapose6d_tpu_torch.interop.from_jax import config_from_run_json
from megapose6d_tpu_torch.meshes import io as mesh_io
from megapose6d_tpu_torch.meshes import worlds
from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase, RigidObject, RigidObjectDataset
from megapose6d_tpu_torch.models.pose_predictor import PosePredictorConfig, build_pose_predictor
from megapose6d_tpu_torch.ops import icp, rasterizer_tiled as rt
from megapose6d_tpu_torch.ops._nvcc import BUILD_DIR
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.scripts import demo_ar_baseline, run_training
from megapose6d_tpu_torch.training import train as tt
from megapose6d_tpu_torch.training.config import TrainingConfig, load_config, make_coarse_cfg, make_refiner_cfg
from megapose6d_tpu_torch.training.forward_loss import draw_forward_loss, draws_to, forward_loss
from megapose6d_tpu_torch.utils import threefry
from megapose6d_tpu_torch.utils.png import read_png

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "runs/ar_baseline/synthdemo"
EVAL_DATA = ROOT / "runs/ar_dr"  # holds synthdemo/, the BOP test set of the committed evaluation
COMMITTED_EVAL = ROOT / "runs/full_eval/synthdemo.bop19/gt+SO3_grid"
WEIGHTS = ROOT / "build/weights"
# The steps the committed runs/ar_dr and runs/ar_gnc reports name; the
# refiner run's latest.txt names a later one (30000).
WEIGHT_FILES = {"coarse_dr": "coarse_dr@5000.npz", "refiner_dr": "refiner_dr@24000.npz"}
AR_GNC = ROOT / "runs/ar_gnc"
# The JAX package's demo_ar_baseline rerun on a CPU at those steps, per
# instance (tests/jax_demo_ar_rerun.py; never committed).
JAX_AR_GNC = ROOT / "build/jax_ar_gnc"
# The JAX package's own run_eval of the first frames on a CPU (written where
# the JAX package is installed, as README.md says; never committed).
JAX_CPU_EVAL = ROOT / "build/jax_cpu_eval/synthdemo.bop19/gt+SO3_grid"
HW = (240, 320)
# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"[{self.name}] ...", flush=True)
        return self

    def __exit__(self, exc_type, *_):
        torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else "FAILED"
        print(f"[{self.name}] {status} in {dt:.1f} s", flush=True)
        return False


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of `fn()` in ms, by CUDA events over `reps` runs."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rot_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angles in degrees between the rotations of poses `[..., 4, 4]`, from
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2) (the trace form loses small
    angles to f32 rounding)."""
    d = (a[..., :3, :3].double() - b[..., :3, :3].double()).flatten(-2).norm(dim=-1)
    return torch.rad2deg(2 * torch.arcsin((d / (2 * 2 ** 0.5)).clamp(0, 1)))


def host_ms(fn, reps: int) -> float:
    """Mean host time in ms of issuing `fn()`, the device not waited for
    between calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def scene_K() -> np.ndarray:
    cam = json.loads((SCENE / "test/000000/scene_camera.json").read_text())
    return np.asarray(cam["0"]["cam_K"], np.float32).reshape(3, 3)


def random_poses(rng: np.random.RandomState, n: int) -> np.ndarray:
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = np.stack(
        [rng.normal(scale=0.02, size=n), rng.normal(scale=0.02, size=n), rng.uniform(0.25, 0.6, n)], -1)
    return T.astype(np.float32)


def compare_visibility(a, b) -> float:
    """Kernel vs plain phase-B outputs. Both do the same f32 operations in
    the same order, so face ids, 1/z and attributes must be identical.
    Returns the largest |difference| of 1/z and attributes on covered
    pixels."""
    (invz_a, fid_a, attr_a), (invz_b, fid_b, attr_b) = a, b
    check(torch.equal(fid_a, fid_b), "face ids differ between kernel and plain")
    hit = fid_a >= 0
    err = 0.0
    if hit.any():
        err = max((invz_a[hit] - invz_b[hit]).abs().max().item(),
                  (attr_a[hit] - attr_b[hit]).abs().max().item())
    check(err == 0.0 and torch.equal(invz_a, invz_b) and torch.equal(attr_a, attr_b),
          f"1/z or attributes differ between kernel and plain (max_abs_err {err})")
    return err


def phase_kernel_vs_plain(errors: list[float]) -> None:
    """Criteria of tests/test_rasterizer_tiled.py: the cube's mask
    identical and depth/rgb/normals within 1e-4; on curved meshes mismatched
    pixels only on the silhouette."""
    rng = np.random.RandomState(0)
    obj2 = mesh_io.load_ply(SCENE / "models/obj_000002.ply").scaled(0.001).with_computed_normals()
    meshes = {
        "cube": mesh_io.make_cube(0.05),
        "uv_sphere": mesh_io.make_uv_sphere(0.05, 16, 24),
        "obj_000002": obj2,
    }
    B = 64
    K = torch.as_tensor(np.tile(scene_K(), (B, 1, 1)), device="cuda")
    for name, m in meshes.items():
        colors = m.vertex_colors if m.vertex_colors is not None else np.full_like(m.vertices, 0.5)
        rep = lambda a: torch.as_tensor(np.repeat(np.asarray(a)[None], B, 0), device="cuda")
        args = (rep(m.vertices), rep(m.vertex_normals), rep(colors), rep(m.faces),
                torch.ones((B, m.n_faces), dtype=torch.bool, device="cuda"))
        TCO = torch.as_tensor(random_poses(rng, B), device="cuda")
        TCO, coefs, ids, n_act = rt.prepare_render(*args, TCO, K, HW)
        vis = (coefs, ids, n_act, HW, 16)
        out_k = rt.visibility_kernel(*vis)
        out_p = rt.visibility_plain(*vis)
        errors.append(compare_visibility(out_k, out_p))
        rk, rp = rt.shade(*out_k, TCO), rt.shade(*out_p, TCO)
        diff = rk.mask != rp.mask
        if name == "cube":
            check(not diff.any(), "cube masks differ")
        else:
            interior = -torch.nn.functional.max_pool2d(
                -rk.mask.float()[:, None], 5, 1, 2)[:, 0] > 0  # erosion by 2 px
            check(not (diff & interior).any(), f"{name}: mismatch inside the silhouette")
        both = rk.mask & rp.mask
        errs = {k: (getattr(rk, k) - getattr(rp, k))[both].abs().max().item() if both.any() else 0.0
                for k in ("depth", "rgb", "normals")}
        check(all(e <= 1e-4 for e in errs.values()), f"{name}: render error {errs}")
        kernel_ms = cuda_ms(lambda: rt.visibility_kernel(*vis), reps=10)
        plain_ms = cuda_ms(lambda: rt.visibility_plain(*vis), reps=2, warmup=1)
        print(f"  {name}: F={m.n_faces} coverage={rk.mask.float().mean().item():.4f} "
              f"mask_mismatch={int(diff.sum())} max_err={errors[-1]:.3g} "
              f"depth/rgb/normals_err={errs['depth']:.3g}/{errs['rgb']:.3g}/{errs['normals']:.3g} "
              f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.3f}", flush=True)


def build_scene_pipeline(cfg_coarse, cfg_refiner, db_kw, inference_cfg, device, seed=0):
    objects = RigidObjectDataset([
        RigidObject(label=p.stem, mesh_path=p, mesh_units="mm")
        for p in sorted((SCENE / "models").glob("*.ply"))
    ])
    mesh_db = MeshDataBase.from_object_ds(
        objects, max_faces=db_kw["max_faces"], n_points=db_kw["n_points_mesh"], n_sym=db_kw["n_sym"],
    ).batched(device=device)
    coarse = build_pose_predictor(cfg_coarse, seed=seed, device=device)
    refiner = build_pose_predictor(cfg_refiner, seed=seed + 1, device=device)
    return PoseEstimator(coarse, refiner, mesh_db, inference_cfg, device=device)


def scene_requests(n: int):
    """The first `n` committed frames of scene 000000, decoded by the
    port's PNG reader, with their ground-truth visible boxes
    (scene_gt_info.json `bbox_visib`) as detections."""
    ds = BOPDataset(SCENE)
    requests = []
    for i in range(n):
        frame = ds[i]
        check(frame.infos.scene_id == "000000" and frame.rgb.shape == HW + (3,), str(frame.infos))
        objs = frame.gt_detections()
        dets = make_detections([o.label for o in objs], np.stack([o.bbox_modal for o in objs]), device="cuda")
        requests.append((ObservationTensor.from_numpy(frame.rgb, frame.camera_data.K), dets))
    return requests


def launch_phases(n_det: int, cfg: InferenceConfig) -> list[str]:
    """The phase of each kernel launch of one request, in launch order: one
    launch per render call, the coarse chunks, then per refiner chunk one per
    iteration, then one per rescoring chunk."""
    coarse = -(-n_det * cfg.SO3_grid_size // min(cfg.bsz_images, n_det * cfg.SO3_grid_size))
    n = n_det * cfg.n_pose_hypotheses
    chunks = -(-n // min(cfg.bsz_objects, n))
    return ["coarse"] * coarse + ["refiner"] * (chunks * cfg.n_refiner_iterations) + ["rescore"] * chunks


def phase_pipeline():
    cfg_c, db_kw = config_from_run_json(ROOT / "runs/coarse_dr/config.json")
    cfg_r, _ = config_from_run_json(ROOT / "runs/refiner_dr/config.json")
    check(cfg_c.backbone == "resnet18-spatial" and cfg_c.compute_dtype == "bfloat16", str(cfg_c))
    check(cfg_r.multiview_type == "TCO+front_1view" and cfg_r.n_rendered_views == 2, str(cfg_r))
    icfg = InferenceConfig()
    check((icfg.SO3_grid_size, icfg.n_pose_hypotheses, icfg.n_refiner_iterations) == (576, 5, 5),
          str(icfg))
    est = build_scene_pipeline(cfg_c, cfg_r, db_kw, icfg, "cuda")
    check(est.mesh_db.has_tex is not None and bool(est.mesh_db.has_tex.all()), "models not textured")
    requests = scene_requests(3)

    rt.visibility_kernel.launches = 0  # the main path starts here
    expected = 0
    for i, (obs, dets) in enumerate(requests):
        t0 = time.perf_counter()
        poses, extra = est.run_inference_pipeline(obs, dets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expected += len(launch_phases(len(dets), icfg))
        tm = extra["timing"]
        print(f"  request {i}{' (warm-up)' if i == 0 else ''}: detections={len(dets)} "
              f"coarse_s={tm['coarse']:.4f} refiner_s={tm['refiner']:.4f} "
              f"scoring_s={tm['scoring']:.4f} total_s={tm['total']:.4f} wall_s={wall:.4f}",
              flush=True)
        P = poses.poses
        check(tuple(P.shape) == (len(dets), 4, 4) and bool(torch.isfinite(P).all()), "bad poses")
        R = P[:, :3, :3]
        orth = (R @ R.transpose(1, 2) - torch.eye(3, device="cuda")).abs().max().item()
        check(orth < 1e-4, f"poses are not rotations: {orth}")
        check(tuple(extra["coarse"]["logits"].shape) == (len(dets), 576), "coarse logits shape")
    launches = rt.visibility_kernel.launches  # read right after the main path
    print(f"  kernel launches on the main path: {launches} (expected {expected})", flush=True)
    check(launches == expected and launches > 0, "the main path did not launch the kernel as expected")
    return est, requests, launches, db_kw


def phase_cross_check(requests, db_kw) -> None:
    """A small f32 run of the pipeline's phases on the GPU and on the CPU
    with the same seeded weights. The coarse sweep and the refiner start
    from the same poses on both devices, so a flipped silhouette pixel
    cannot cascade. Logits: all within 0.05, at least 90% within 1e-3;
    refined poses within 0.1 degree and 0.1 mm."""
    cfg_c, _ = config_from_run_json(ROOT / "runs/coarse_dr/config.json")
    cfg_r, _ = config_from_run_json(ROOT / "runs/refiner_dr/config.json")
    f32 = lambda c: PosePredictorConfig(**{**c.__dict__, "compute_dtype": "float32"})
    icfg = InferenceConfig(SO3_grid_size=16, n_pose_hypotheses=3, n_refiner_iterations=2)
    obs, dets = requests[0]
    out = {}
    for dev in ("cuda", "cpu"):
        est = build_scene_pipeline(f32(cfg_c), f32(cfg_r), db_kw, icfg, dev)
        with torch.inference_mode():
            idx = est.mesh_db.label_to_index(dets.labels[:1])
            images, K = obs.images.to(dev), obs.K.to(dev)
            logits, TCO_init = est.coarse_logits(16, images, K, dets.bboxes[:1].to(dev), idx)
            if dev == "cuda":
                top = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :3]
                T0 = TCO_init[0, top[0]].cpu()
            refined, _ = est.refine(3, 2, images, K, T0.to(dev), idx.repeat_interleave(3))
        out[dev] = (logits.cpu(), refined.cpu())
    d = (out["cuda"][0] - out["cpu"][0]).abs()
    check(d.max().item() < 0.05 and (d < 1e-3).float().mean().item() >= 0.9, f"coarse logits {d}")
    deg = rot_deg(out["cuda"][1], out["cpu"][1]).max().item()
    mm = (out["cuda"][1][:, :3, 3] - out["cpu"][1][:, :3, 3]).abs().max().item() * 1000
    check(deg < 0.1 and mm < 0.1, f"refined poses differ: {deg} deg, {mm} mm")
    print(f"  gpu vs cpu: coarse logit max_err={d.max().item():.3g} "
          f"refined rot_err_deg={deg:.3g} trans_err_mm={mm:.3g}", flush=True)


def work(coefs, ids, n_act, hw, chunk) -> tuple[int, int]:
    """(flops, bytes) of one launch: the plane evaluations of every face of
    every active chunk (2 multiplies and 2 adds per edge/1/z plane per
    face-pixel), and the bytes this launch's data needs, each read or
    written once: `n_active`, the active entries of each tile's chunk list,
    the 30 plane coefficients (not the 2 of padding) of each face of a chunk
    that some tile of its image makes active, and 32 bytes of output per
    pixel."""
    B, _, n_chunks = ids.shape
    H, W = hw
    n_pairs = int(n_act.sum())
    active = torch.arange(n_chunks, device=ids.device) < n_act[..., None]
    used = torch.zeros((B, n_chunks + 1), dtype=torch.bool, device=ids.device)
    used.scatter_(1, torch.where(active, ids.long(), n_chunks).reshape(B, -1), True)
    n_coefs = int(used[:, :n_chunks].sum()) * chunk * (rt.COEF_W - 2)
    flops = 4 * 4 * chunk * rt.TILE_H * rt.TILE_W * n_pairs
    nbytes = n_act.numel() * 4 + n_pairs * 4 + n_coefs * 4 + B * H * W * (4 + 4 + 4 * 6)
    return flops, nbytes


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for this work, and what sets it:
    the flops over the f32 rate against the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def live_face_warps(coefs, ids, n_act, hw) -> tuple[int, int]:
    """(face, warp) pairs the kernel's cull leaves to evaluate, and all
    (face, warp) pairs of the active chunks, counted with its plain twin
    `rt.cull_plain` a few images at a time."""
    live = 0
    for s in range(0, coefs.shape[0], 16):
        live += int(rt.cull_plain(coefs[s : s + 16], ids[s : s + 16], n_act[s : s + 16], hw).sum())
    return live, int(n_act.sum()) * rt.KERNEL_CHUNK * (rt.TILE_H // rt.WARP_ROWS)


def tile_work(launches: list) -> dict:
    """How a group of launches spreads over the kernel's blocks, one per
    (image, tile), each walking its tile's active chunks in series: active
    tiles per image and active chunks per active tile (mean, max), and per
    launch the chunks of its longest tile."""
    per_image = torch.cat([(vis[2] > 0).sum(1) for vis in launches]).float()
    per_tile = torch.cat([vis[2][vis[2] > 0] for vis in launches]).float()
    return dict(tiles_per_image=(per_image.mean().item(), int(per_image.max())),
                chunks_per_tile=(per_tile.mean().item(), int(per_tile.max())) if len(per_tile) else (0.0, 0),
                longest=[int(vis[2].max()) for vis in launches])


def tile_work_line(key: str, launches: list) -> str:
    w = tile_work(launches)
    return (f"  {key} tiles: active tiles per image mean {w['tiles_per_image'][0]:.2f} max "
            f"{w['tiles_per_image'][1]} of {launches[0][1].shape[1]}; chunks per active tile mean "
            f"{w['chunks_per_tile'][0]:.2f} max {w['chunks_per_tile'][1]}; longest tile per launch mean "
            f"{np.mean(w['longest']):.2f} chunks")


def record_visibility_inputs(captured: list):
    """Route phase B through a recorder that keeps a copy of every launch's
    inputs and calls on to the kernel; returns the function to restore."""
    visibility = rt.visibility

    def record(coefs, ids, n_act, hw, chunk):
        captured.append((coefs.clone(), ids.clone(), n_act.clone(), tuple(hw), chunk))
        return visibility(coefs, ids, n_act, hw, chunk)

    rt.visibility = record
    return visibility


def capture_launches(est, obs, dets) -> list[tuple]:
    """The phase-B inputs of every render of one more request, in launch
    order (the kernel launches as on the main path)."""
    captured: list = []
    restore = record_visibility_inputs(captured)
    try:
        est.run_inference_pipeline(obs, dets)
    finally:
        rt.visibility = restore
    return captured


def phase_kernel_timing(est, requests, errors: list[float]) -> dict:
    """The kernel at the phase-B inputs of every render of one more
    request: the coarse sweep (576 hypotheses per detection), the refiner
    iterations and the rescoring. Each launch is held bit for bit against
    the plain twin, and both are timed. Per phase and batch size: the means
    over its launches of the kernel's and the plain twin's times and of the
    bound. At the first coarse launch also: the store floor (the same
    tables with no active chunk: only the outputs' stores) and the share of
    face evaluations that the kernel's cull leaves."""
    obs, dets = requests[-1]
    with torch.inference_mode():
        launches = capture_launches(est, obs, dets)
        per_launch, plain, works = [], [], []
        for vis in launches:
            errors.append(compare_visibility(rt.visibility_kernel(*vis), rt.visibility_plain(*vis)))
            per_launch.append(cuda_ms(lambda: rt.visibility_kernel(*vis), reps=20, warmup=3))
            plain.append(cuda_ms(lambda: rt.visibility_plain(*vis), reps=1, warmup=0))
            works.append(work(*vis))
        coarse = launches[0]
        coefs, ids, n_act, hw, chunk = coarse
        empty = (coefs, ids, torch.zeros_like(n_act), hw, chunk)
        errors.append(compare_visibility(rt.visibility_kernel(*empty), rt.visibility_plain(*empty)))
        store_floor_ms = cuda_ms(lambda: rt.visibility_kernel(*empty), reps=20, warmup=3)
        live, pairs = live_face_warps(coefs, ids, n_act, hw)
    phases = launch_phases(len(dets), est.cfg)
    check(len(launches) == len(phases), "captured launches")
    bound_ms, bound_by = bound(*works[0])
    print(f"  coarse shapes: B={coefs.shape[0]} F={coefs.shape[1]} T={ids.shape[1]} "
          f"active_chunks={int(n_act.sum())} flops={works[0][0]:.4g} bytes={works[0][1]:.4g}", flush=True)
    print(f"  store floor (no active chunk): kernel_ms={store_floor_ms:.4f}; cull: {live} of {pairs} "
          f"(face, warp) pairs evaluated ({live / max(pairs, 1):.4f}), "
          f"{live * rt.WARP_ROWS * rt.TILE_W:.4g} face-pixel evaluations", flush=True)

    # Per phase and batch size: the mean over the request's launches.
    groups: dict[str, list[int]] = {}
    for i, (phase, vis) in enumerate(zip(phases, launches)):
        groups.setdefault(f"{phase}_B{vis[0].shape[0]}", []).append(i)
    by_shape = {}
    for key, idx in groups.items():
        mean = lambda xs: sum(xs[i] for i in idx) / len(idx)
        g_ms, g_by = bound(mean([w[0] for w in works]), mean([w[1] for w in works]))
        by_shape[key] = dict(launches=len(idx), ms=mean(per_launch), plain_ms=mean(plain),
                             bound_ms=g_ms, bound_by=g_by)
        print(f"  {key}: launches_per_request={len(idx)} kernel_ms={mean(per_launch):.4f} "
              f"plain_ms={mean(plain):.3f} bound_ms={g_ms:.4f} ({g_by}); per launch (kernel / bound ms) "
              f"{', '.join(f'{per_launch[i]:.4f} / {bound(*works[i])[0]:.4f}' for i in idx)}", flush=True)
        print(tile_work_line(key, [launches[i] for i in idx]), flush=True)
    request_ms = sum(per_launch)
    print(f"  first coarse launch: kernel_ms={per_launch[0]:.4f} bound_ms={bound_ms:.4f} "
          f"share_of_bound={bound_ms / per_launch[0]:.4f}; kernel device time per request: "
          f"{request_ms:.4f} ms over {len(launches)} launches", flush=True)
    return dict(ms=per_launch[0], plain_ms=plain[0], bound_ms=bound_ms, bound_by=bound_by,
                store_floor_ms=store_floor_ms, request_ms=request_ms, by_shape=by_shape)


def sass_report() -> None:
    """The kernel's loops in the SASS of the built library (where the
    toolkit has cuobjdump): for each loop (a branch back), its instructions,
    its shared-memory loads and its f32 multiplies and adds. The listing
    goes to `visibility.sass` beside the library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = sorted(BUILD_DIR.glob("visibility-*.so"))
    if not Path(cuobjdump).exists() or not libs:
        print("  cuobjdump or the library not found: SASS not read", flush=True)
        return
    proc = subprocess.run([cuobjdump, "-sass", str(libs[-1])], capture_output=True, text=True, timeout=120)
    (BUILD_DIR / "visibility.sass").write_text(proc.stdout)
    code = [(int(m.group(1), 16), m.group(2)) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", proc.stdout)]
    op = lambda i: i.split()[1] if i.startswith("@") else i.split()[0]
    loads = lambda seq: ", ".join(f"{k} {v}" for k, v in sorted(Counter(op(i) for _, i in seq).items())
                                  if k.startswith(("LDS", "FMUL", "FADD"))) or "no LDS, FMUL or FADD"
    print(f"  sass, whole kernel: {len(code)} instructions, {loads(code)}", flush=True)
    for end, instr in code:
        target = instr.split()[-1]
        if op(instr) == "BRA" and target.startswith("0x") and int(target, 16) < end:
            body = [(a, i) for a, i in code if int(target, 16) <= a <= end]
            print(f"  sass, loop {target}-{end:#x}: {len(body)} instructions, {loads(body)}", flush=True)


def phase_profile(est, requests) -> None:
    from torch.profiler import ProfilerActivity, profile

    obs, dets = requests[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.run_inference_pipeline(obs, dets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    device_us = lambda e: e.self_device_time_total
    # Device-side events only (kernels, copies): host ops would count them twice.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    if not events:
        print("  the profiler saw no device time: busy share not measured", flush=True)
        return
    print(f"  traced request: wall_ms={wall_ms:.2f} device_busy_ms={busy_ms:.2f} "
          f"idle_share={1 - busy_ms / wall_ms:.3f}", flush=True)
    for e in sorted(events, key=device_us, reverse=True)[:10]:
        print(f"  device_ms={device_us(e) / 1e3:9.3f} calls={e.count:6d} {e.key[:90]}", flush=True)


def shape_group(launches: list, errors: list[float]) -> tuple[dict, list[float]]:
    """The kernel at a group of captured launches: each held bit for bit
    against the plain twin and timed; the means of the kernel's time and
    of the bound, the plain twin's time at the first launch, and the
    kernel's time per launch."""
    per_launch, works = [], []
    for vis in launches:
        errors.append(compare_visibility(rt.visibility_kernel(*vis), rt.visibility_plain(*vis)))
        per_launch.append(cuda_ms(lambda: rt.visibility_kernel(*vis), reps=20, warmup=3))
        works.append(work(*vis))
    plain_ms = cuda_ms(lambda: rt.visibility_plain(*launches[0]), reps=1, warmup=0)
    n = len(launches)
    bound_ms, bound_by = bound(sum(w[0] for w in works) / n, sum(w[1] for w in works) / n)
    return dict(launches=n, ms=sum(per_launch) / n, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by), per_launch


def ar_tolerances(n: int) -> dict[str, float]:
    """How far the port's ARs may be from the committed summary
    (tests/test_torch_eval.py): one (instance, threshold) flip of n x 10
    for MSSD and MSPD, 0.002 for VSD, and their mean for AR."""
    flip = 1.0001 / (10 * n)
    return {"AR_MSSD": flip, "AR_MSPD": flip, "AR_VSD": 0.002, "AR": (2 * flip + 0.002) / 3}


def phase_eval_rescore(errors: list[float]) -> tuple[int, dict]:
    """The committed JAX predictions, scored by the port's meters on the GPU
    (run_eval with skip_inference), every VSD render through the kernel."""
    save_root = BUILD_DIR / "eval_rescore"
    shutil.rmtree(save_root, ignore_errors=True)
    cfg = EvalConfig(ds_name="synthdemo.bop19", data_dir=str(EVAL_DATA), save_dir=str(save_root),
                     skip_inference=True, load_depth=True, device="cuda")
    get_save_dir(cfg).mkdir(parents=True)
    for f in ("results.npz", "results.json"):
        shutil.copy(COMMITTED_EVAL / f, get_save_dir(cfg) / f)
    captured: list = []
    restore = record_visibility_inputs(captured)
    rt.visibility_kernel.launches = 0  # the eval-rescore path starts here
    try:
        t0 = time.perf_counter()
        out = run_eval(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rt.visibility = restore
    launches = rt.visibility_kernel.launches  # read right after the path
    got, want = out["summary"], json.loads((COMMITTED_EVAL / "summary.json").read_text())
    n = got["bop"]["n"]
    print(f"  rescored in {wall:.2f} s: n={n} (committed {want['bop']['n']})", flush=True)
    for k in ("AR", "AR_VSD", "AR_MSSD", "AR_MSPD"):
        print(f"  {k}: port {got['bop'][k]:.6f} committed {want['bop'][k]:.6f}", flush=True)
    print(f"  ADD-0.1d: port {got['modelnet']['ADD_0.1d']:.6f} committed {want['modelnet']['ADD_0.1d']:.6f}; "
          f"mssd_median port {got['bop']['mssd_median']:.9g} committed {want['bop']['mssd_median']:.9g}",
          flush=True)
    check(n == 109, f"n={n}, expected 109")
    for k, tol in ar_tolerances(n).items():
        check(abs(got["bop"][k] - want["bop"][k]) <= tol, f"{k} {got['bop'][k]} vs {want['bop'][k]}")
    sizes = Counter(vis[0].shape[0] for vis in captured)
    print(f"  VSD launches: {launches} (2 per frame), batch sizes {dict(sorted(sizes.items()))}", flush=True)
    check(launches == len(captured) == 2 * 56, f"{launches} VSD launches, {len(captured)} captured")
    # Both VSD renders of the first frame, bit for bit against the plain twin.
    for vis in captured[:2]:
        errors.append(compare_visibility(rt.visibility_kernel(*vis), rt.visibility_plain(*vis)))
    b = sizes.most_common(1)[0][0]
    same = [vis for vis in captured if vis[0].shape[0] == b]
    group, per_launch = shape_group(same, errors)
    print(f"  vsd_B{b}: launches={group['launches']} kernel_ms={group['ms']:.4f} "
          f"plain_ms={group['plain_ms']:.3f} bound_ms={group['bound_ms']:.4f} ({group['bound_by']}); "
          f"every launch of the group held bit for bit against the plain twin", flush=True)
    # What a launch at this shape waits for: its stores alone (no active
    # chunk), the host's cost of issuing one launch, and the longest chain
    # of chunks one block walks.
    empty = [(c, i, torch.zeros_like(a), hw, ch) for c, i, a, hw, ch in same]
    floor = np.mean([cuda_ms(lambda: rt.visibility_kernel(*vis), reps=20, warmup=3) for vis in empty])
    issue = np.mean([host_ms(lambda: rt.visibility_kernel(*vis), reps=20) for vis in empty])
    print(tile_work_line(f"vsd_B{b}", same), flush=True)
    longest = np.asarray(tile_work(same)["longest"], np.float64)
    slope, icpt = np.polyfit(longest, per_launch, 1)
    r = np.corrcoef(longest, per_launch)[0, 1]
    print(f"  vsd_B{b} store floor (no active chunk): kernel_ms={floor:.4f}, host issue per launch "
          f"{issue:.4f} ms; kernel_ms against the longest "
          f"tile's chunks over {len(same)} launches: {icpt:.4f} + {slope * 1e3:.3f} us per chunk (r={r:.3f}); "
          f"longest {longest.min():.0f}-{longest.max():.0f} chunks, kernel_ms {min(per_launch):.4f}-"
          f"{max(per_launch):.4f}", flush=True)
    return launches, {f"vsd_B{b}": group}


def instance_scores(final, scene_ds, mesh_db) -> np.ndarray:
    """Each instance's share of AR_VSD, AR_MSSD and AR_MSPD, `[n, 3]` in the
    meters' order: its hits over each part's thresholds. Their means over
    the instances are the parts' ARs (checked against the meter)."""
    width = scene_ds[0].rgb.shape[1]
    meter = BOPScoreMeter(mesh_db, image_width=width)
    summary = EvaluationRunner(scene_ds, {"bop": meter}).evaluate(final)["bop"]
    d = {k: np.asarray(v) for k, v in meter.datas.items()}
    mssd = np.mean([d["mssd"] < t * d["diameter"] for t in np.arange(0.05, 0.51, 0.05)], 0)
    mspd = np.mean([d["mspd"] < t * width / 640 for t in np.arange(5.0, 50.1, 5.0)], 0)
    vsd = np.mean([(d["vsd"] < th).mean(1) for th in BOP19_THRESHOLDS], 0)
    scores = np.stack([vsd, mssd, mspd], 1)
    want = [summary[k] for k in ("AR_VSD", "AR_MSSD", "AR_MSPD")]
    check(np.allclose(scores.mean(0), want, rtol=0, atol=1e-9), "per-instance scores do not add up to the ARs")
    return scores


def compare_runs(name: str, a: dict, b: dict, sa: np.ndarray, sb: np.ndarray) -> None:
    """Two prediction bundles of the same instances, per instance. Each
    instance is put in one of three kinds by where the two picked
    hypotheses stood after the first refiner iteration (5 degrees apart or
    more: not the same coarse hypothesis): the same start; b's start among
    a's K but not picked (the rescoring); or not among a's K (the coarse
    ranking). Per kind: its instances, those whose scores differ, their
    share of each AR part's gap (a - b) and the median distance between
    the final poses."""
    keys = ("scene_id", "view_id", "label", "instance_id")
    rows = lambda tc: list(zip(*(tc.infos[k].tolist() for k in keys)))
    check(rows(a["final"]) == rows(b["final"]), f"{name}: the runs' instances differ")
    n = len(a["final"])
    last = max(int(k.split("=")[1]) for k in a if k.startswith("refiner/"))

    def stage(p: dict, it: int):
        tc = p[f"refiner/iteration={it}"]
        k = len(tc) // n
        check(tc.infos["hypothesis_id"].tolist() == list(range(k)) * n, f"{name}: hypothesis order")
        return tc.poses.double().reshape(n, k, 4, 4), torch.as_tensor(tc.infos["pose_logit"]).reshape(n, k)

    a1, b1 = stage(a, 1)[0], stage(b, 1)[0]
    ar = torch.arange(n)
    start_b = b1[ar, stage(b, last)[1].argmax(1)]
    same = rot_deg(a1[ar, stage(a, last)[1].argmax(1)], start_b) < 5
    among = (rot_deg(a1, start_b[:, None]) < 5).any(1)
    kind = torch.where(same, 0, torch.where(among, 1, 2)).numpy()
    fa, fb = a["final"].poses.double(), b["final"].poses.double()
    deg = rot_deg(fa, fb).numpy()
    mm = ((fa[:, :3, 3] - fb[:, :3, 3]).norm(dim=1) * 1e3).numpy()
    d = sa - sb
    gap = d.mean(0)
    print(f"  {name}: n={n}, gaps AR_VSD {gap[0]:+.6f} AR_MSSD {gap[1]:+.6f} AR_MSPD {gap[2]:+.6f} "
          f"AR {gap.mean():+.6f}; instances with other scores {int((d != 0).any(1).sum())}", flush=True)
    for k, label in enumerate(("same start", "rescoring picked another", "coarse top-K differs")):
        m = kind == k
        share = d[m].sum(0) / n
        med = lambda x: f"{np.median(x[m]):.3f}" if m.any() else "-"
        print(f"    {label}: {int(m.sum())} instances, {int((d[m] != 0).any(1).sum())} with other scores; "
              f"share of the gaps VSD {share[0]:+.6f} MSSD {share[1]:+.6f} MSPD {share[2]:+.6f}; "
              f"final poses apart median {med(deg)} deg {med(mm)} mm", flush=True)


def frames_of(bundle: dict, frames: set) -> dict:
    """A prediction bundle cut to the rows of `frames` ((scene_id, view_id))."""
    keep = lambda tc: [i for i, f in enumerate(zip(tc.infos["scene_id"].tolist(), tc.infos["view_id"].tolist()))
                       if f in frames]
    return {k: tc[keep(tc)] for k, tc in bundle.items()}


def trained_vs_committed(cfg: EvalConfig, results_path: Path) -> None:
    """The trained run against the committed JAX predictions, per instance;
    and the same frames again with both models computing in f32, against
    both: how far the card's bf16 run is from JAX's, and how far the
    precision alone moves the port. Where the JAX package's own run of the
    first frames on a CPU is in the copy (`JAX_CPU_EVAL`), all three runs
    against it on its frames."""
    f32_runs = BUILD_DIR / "f32_runs"
    for run in ("coarse_dr", "refiner_dr"):
        d = json.loads((ROOT / "runs" / run / "config.json").read_text())
        (f32_runs / run).mkdir(parents=True, exist_ok=True)
        (f32_runs / run / "config.json").write_text(json.dumps({**d, "compute_dtype": "float32"}))
    t0 = time.perf_counter()
    out32 = run_eval(dataclasses.replace(cfg, coarse_run=str(f32_runs / "coarse_dr"),
                                         refiner_run=str(f32_runs / "refiner_dr"),
                                         save_dir=str(BUILD_DIR / "eval_run_f32")))
    bop32 = out32["summary"]["bop"]
    print(f"  the same frames with the models in f32: {time.perf_counter() - t0:.2f} s; AR {bop32['AR']:.6f} "
          f"AR_VSD {bop32['AR_VSD']:.6f} AR_MSSD {bop32['AR_MSSD']:.6f} AR_MSPD {bop32['AR_MSPD']:.6f}", flush=True)
    scene_ds = make_scene_dataset(cfg.ds_name, load_depth=True, data_dir=cfg.data_dir)
    mesh_db = MeshDataBase.from_object_ds(make_object_dataset(cfg.ds_name, data_dir=cfg.data_dir),
                                          max_faces=cfg.max_faces).batched(device="cuda")
    runs = {"port bf16": load_predictions(results_path), "port f32": load_predictions(out32["results_path"]),
            "jax": load_predictions(COMMITTED_EVAL / "results.npz")}
    scores = {k: instance_scores(v["final"], scene_ds, mesh_db) for k, v in runs.items()}
    for a, b in (("port bf16", "jax"), ("port f32", "jax"), ("port bf16", "port f32")):
        compare_runs(f"{a} vs {b}", runs[a], runs[b], scores[a], scores[b])
    if not (JAX_CPU_EVAL / "results.npz").exists():
        print(f"  no JAX CPU run in {JAX_CPU_EVAL}: not compared", flush=True)
        return
    cpu = load_predictions(JAX_CPU_EVAL / "results.npz")
    final = cpu["final"]
    frames = set(zip(final.infos["scene_id"].tolist(), final.infos["view_id"].tolist()))
    runs = {"jax cpu": cpu, **{k: frames_of(v, frames) for k, v in runs.items()}}
    scores = {k: instance_scores(v["final"], scene_ds, mesh_db) for k, v in runs.items()}
    print(f"  the JAX package's run on a CPU: {len(frames)} frames", flush=True)
    for a, b in (("jax cpu", "jax"), ("port bf16", "jax cpu"), ("port f32", "jax cpu")):
        compare_runs(f"{a} vs {b}", runs[a], runs[b], scores[a], scores[b])


def phase_eval_run() -> int:
    """The port's run_eval with the committed evaluation's inference
    settings: seeded weights on 8 frames, or the trained weights on all 56
    frames when their npz files exist."""
    ecfg = json.loads((COMMITTED_EVAL / "eval_config.json").read_text())
    # SO3_prune_keep is read only by a mode not ported yet.
    icfg = InferenceConfig(**{k: v for k, v in ecfg["inference"].items() if k != "SO3_prune_keep"})
    trained = all((WEIGHTS / f).exists() for f in WEIGHT_FILES.values())
    print(f"  weights: {'trained, ' + str(WEIGHTS) if trained else 'seeded (no npz files in build/weights)'}; "
          f"frames: {'all' if trained else 8}; inference {icfg}", flush=True)
    save_root = BUILD_DIR / "eval_run"
    shutil.rmtree(save_root, ignore_errors=True)
    weights = lambda run: str(WEIGHTS / WEIGHT_FILES[run]) if trained else ""
    cfg = EvalConfig(
        coarse_run=str(ROOT / ecfg["coarse_run"]), refiner_run=str(ROOT / ecfg["refiner_run"]),
        coarse_weights=weights("coarse_dr"), refiner_weights=weights("refiner_dr"),
        ds_name=ecfg["ds_name"], data_dir=str(EVAL_DATA), inference=icfg, save_dir=str(save_root),
        n_frames=None if trained else 8, render_size=tuple(ecfg["render_size"]),
        max_faces=ecfg["max_faces"], load_depth=True, device="cuda",
    )
    rt.visibility_kernel.launches = 0  # the eval-run path starts here
    t0 = time.perf_counter()
    out = run_eval(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rt.visibility_kernel.launches  # read right after the path
    final = load_predictions(out["results_path"])["final"]
    rows = list(zip(final.infos["scene_id"].tolist(), final.infos["view_id"].tolist()))
    frames = sorted(set(rows))  # the dataset's order
    dets = [rows.count(f) for f in frames]
    secs = [float(final.infos["time"][rows.index(f)]) for f in frames]
    csv_rows = len((get_save_dir(cfg) / "synthdemo.csv").read_text().splitlines()) - 1
    summary = out["summary"]
    print(f"  {len(frames)} frames in {wall:.2f} s; seconds per frame (first is warm-up): "
          f"{', '.join(f'{x:.4f}' for x in secs)}", flush=True)
    print(f"  CSV rows: {csv_rows}; summary: {json.dumps(summary)}", flush=True)
    if trained:
        print(f"  trained AR on the card (coarse@5000, refiner@24000): {summary['bop']['AR']:.6f} "
              f"(committed JAX evaluation 0.2453)", flush=True)
    expected = sum(len(launch_phases(d, icfg)) for d in dets) + 2 * len(frames)
    print(f"  kernel launches: {launches} (expected {expected}: the pipeline's and 2 VSD renders per frame)",
          flush=True)
    check(csv_rows == len(final) == summary["bop"]["n"] > 0, "CSV rows, predictions and summary disagree")
    check(launches == expected, "the eval run did not launch the kernel as expected")
    if trained:
        trained_vs_committed(cfg, out["results_path"])
    return launches


def perturbed_pose(T: np.ndarray, rng: np.random.RandomState, deg: float = 4.0, mm: float = 8.0) -> np.ndarray:
    """`T` turned by `deg` about a random axis and shifted by N(0, mm)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    out = np.asarray(T, np.float64).copy()
    out[:3, :3] = (np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx) @ out[:3, :3]
    out[:3, 3] += rng.normal(scale=mm * 1e-3, size=3)
    return out.astype(np.float32)


def profile_call(fn) -> tuple[float, float, list[str], int]:
    """(wall ms, device busy ms, the three kernels of most device time, the
    K1 launches the trace saw) of one call of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = [f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
           for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:3]]
    k1 = sum(e.count for e in events if "visibility_kernel" in e.key)
    return wall, busy, top, k1


def ar_gnc_frames(seed: int = 0) -> list:
    """The 10 frames of runs/ar_gnc/synthdemo with their measured depth, and
    their ground-truth poses perturbed from `seed` (4 degrees, N(0, 8 mm))."""
    ds = BOPDataset(AR_GNC / "synthdemo", load_depth=True)
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(len(ds)):
        f = ds[i]
        objs = f.gt_detections()
        frames.append((f, [o.label for o in objs], np.stack([perturbed_pose(o.TWO, rng) for o in objs])))
    return frames


def refine_frame(refiner, frame, labels, poses, device):
    out, extra = refiner.refine_poses(
        TensorCollection(labels, poses=torch.as_tensor(poses, device=device)),
        depth=torch.as_tensor(frame.depth, device=device),
        K=torch.as_tensor(frame.camera_data.K.astype(np.float32), device=device))
    return out.poses, extra


SPHERE = "obj_000002"  # the textured UV sphere of runs/ar_gnc/synthdemo


def phase_depth_refiners(errors: list[float]) -> tuple[int, dict]:
    """Both depth refiners on the GPU and, with the plain phase B, on the
    CPU, at perturbed ground truth of the 10 ar_gnc frames. Held: equal
    `valid`; GNC poses within 0.05 degree and 0.05 mm; ICP poses of the
    cubes within 0.05 degree and 0.05 mm. ICP on the sphere is not held:
    point-to-plane ICP cannot observe a sphere's rotation about its centre
    (its normal equations have a condition number ~1e5,
    tests/test_torch_depth.py), so rounding steers the solve, and in the
    JAX package too a start shifted by 1 um can end centimetres away. For
    each sphere instance the gap is printed beside how far the CPU's own
    result moves when its start shifts by 1 um. Every depth render (one
    launch per frame and refiner) is held bit for bit against the plain
    twin and timed."""
    frames = ar_gnc_frames()
    dbs = {d: demo_ar_baseline.world_mesh_db(AR_GNC / "synthdemo", d) for d in ("cuda", "cpu")}
    kinds = {"icp": ICPRefiner, "gnc": GNCRegistrationRefiner}
    refiners = {(k, d): cls(dbs[d]) for k, cls in kinds.items() for d in dbs}
    for k in kinds:  # warm-up: the kernel's first launch and the solvers' handles
        refine_frame(refiners[k, "cuda"], *frames[0], "cuda")
    captured: list = []
    gpu: dict = {k: [] for k in kinds}
    secs: dict = {k: [] for k in kinds}
    restore = record_visibility_inputs(captured)
    rt.visibility_kernel.launches = 0  # the depth-refiner path starts here
    try:
        for k in kinds:
            for frame, labels, poses in frames:
                t0 = time.perf_counter()
                P, extra = refine_frame(refiners[k, "cuda"], frame, labels, poses, "cuda")
                torch.cuda.synchronize()
                secs[k].append(time.perf_counter() - t0)
                gpu[k].append((P.cpu(), extra["valid"].cpu()))
    finally:
        rt.visibility = restore
    launches = rt.visibility_kernel.launches  # read right after the path
    check(launches == len(captured) == 2 * len(frames), f"{launches} depth-render launches")
    bad = []
    for k in kinds:
        held, n_valid, spheres = [], 0, []
        for (frame, labels, poses), (Pg, vg) in zip(frames, gpu[k]):
            Pc, extra = refine_frame(refiners[k, "cpu"], frame, labels, poses, "cpu")
            check(torch.equal(vg, extra["valid"]), f"{k}: valid flags differ between GPU and CPU")
            check(bool(torch.isfinite(Pg).all()), f"{k}: non-finite poses")
            n_valid += int(vg.sum())
            deg, mm = rot_deg(Pg, Pc), (Pg[:, :3, 3] - Pc[:, :3, 3]).abs().amax(-1) * 1e3
            shifted = None
            for i, (l, d, m) in enumerate(zip(labels, deg.tolist(), mm.tolist())):
                if k == "icp" and l == SPHERE:
                    if shifted is None:
                        p2 = poses.copy()
                        p2[:, 0, 3] += 1e-6
                        shifted = refine_frame(refiners[k, "cpu"], frame, labels, p2, "cpu")[0]
                    spheres.append((d, m, rot_deg(Pc[i], shifted[i]).item(),
                                    (Pc[i, :3, 3] - shifted[i, :3, 3]).abs().max().item() * 1e3))
                    continue
                held.append((d, m))
                if d > 0.05 or m > 0.05:
                    bad.append((k, l, d, m))
        print(f"  {k}: {sum(len(l) for _, l, _ in frames)} instances, {n_valid} valid; gpu vs cpu, held "
              f"instances ({len(held)}): max {max(h[0] for h in held):.4g} deg {max(h[1] for h in held):.4g} mm; "
              f"seconds per frame {', '.join(f'{x:.4f}' for x in secs[k])}", flush=True)
        if spheres:
            print(f"  {k} sphere instances, gpu vs cpu (deg, mm) beside the cpu's own move after a 1 um start "
                  f"shift (deg, mm): " + "; ".join(f"({a:.3g}, {b:.3g}) vs ({c:.3g}, {e:.3g})"
                                                   for a, b, c, e in spheres), flush=True)
    # Where a refine spends its time: one frame with two objects.
    f2 = next(fr for fr in frames if len(fr[1]) == 2)
    for k in kinds:
        wall, busy, top, _ = profile_call(lambda: refine_frame(refiners[k, "cuda"], *f2, "cuda"))
        print(f"  {k} traced refine (2 objects): wall_ms={wall:.3f} device_busy_ms={busy:.3f} "
              f"idle_share={1 - busy / wall:.3f}; top: {'; '.join(top)}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    p = torch.rand((2, 1024, 3), device="cuda", generator=g)
    q = torch.rand((2, 1024, 3), device="cuda", generator=g)
    dist_ms = cuda_ms(lambda: ((p[:, :, None] - q[:, None]) ** 2).sum(-1).argmin(-1), reps=30)
    A = torch.eye(6, device="cuda").repeat(2, 1, 1) + 0.1 * torch.rand((2, 6, 6), device="cuda", generator=g)
    b = torch.rand((2, 6, 1), device="cuda", generator=g)
    solve_ms = cuda_ms(lambda: torch.linalg.solve_ex(A, b), reps=30)
    S = torch.rand((2, 3, 3), device="cuda", generator=g)
    svd_ms = cuda_ms(lambda: torch.linalg.svd(S), reps=21)
    print(f"  parts, 2 objects: ICP distance pass + argmin [2, 1024, 1024] {dist_ms:.4f} ms (x30 = "
          f"{30 * dist_ms:.3f}); 6x6 solve {solve_ms:.4f} ms (x30 = {30 * solve_ms:.3f}); batched 3x3 SVD "
          f"{svd_ms:.4f} ms (x21 = {21 * svd_ms:.3f})", flush=True)
    check(not bad, f"depth refiners differ between GPU and CPU: {bad}")
    sizes = Counter(vis[0].shape[0] for vis in captured)
    shapes = {}
    for b_ in sorted(sizes):
        group, per_launch = shape_group([vis for vis in captured if vis[0].shape[0] == b_], errors)
        hw = captured[0][3]
        print(f"  depth_refiner_B{b_} ({hw[0]}x{hw[1]}): launches={group['launches']} kernel_ms={group['ms']:.4f} "
              f"plain_ms={group['plain_ms']:.3f} bound_ms={group['bound_ms']:.4f} ({group['bound_by']}); "
              f"every launch held bit for bit against the plain twin", flush=True)
        print(tile_work_line(f"depth_refiner_B{b_}", [vis for vis in captured if vis[0].shape[0] == b_]),
              flush=True)
        shapes[f"depth_refiner_B{b_}"] = group
    return launches, shapes


def phase_rgbd() -> int:
    """The two named RGB-D configurations at full width with seeded
    weights, two requests each on an ar_gnc frame with its depth."""
    from megapose6d_tpu_torch.data.bop_scene_dataset import load_bop_object_dataset

    frame = BOPDataset(AR_GNC / "synthdemo", load_depth=True)[0]
    objs = frame.gt_detections()
    objects = load_bop_object_dataset(AR_GNC / "synthdemo/models")
    total = 0
    for name in ("megapose-1.0-RGBD", "megapose-1.0-RGB-multi-hypothesis-icp"):
        est = load_named_model(name, objects, device="cuda")
        c, r = est.coarse_model.cfg, est.refiner_model.cfg
        check(c.backbone == r.backbone == "resnet34" and r.render_size == HW and c.compute_dtype == "bfloat16"
              and est.cfg.SO3_grid_size == 576, f"{name}: not the named width")
        obs = ObservationTensor.from_numpy(frame.rgb, frame.camera_data.K, depth=frame.depth)
        dets = make_detections([o.label for o in objs], np.stack([o.bbox_modal for o in objs]), device="cuda")
        depth_stage = est.depth_refiner is not None
        rt.visibility_kernel.launches = 0  # this configuration's path starts here
        for i in range(2):
            poses, extra = est.run_inference_pipeline(obs, dets)
            tm = extra["timing"]
            check(bool(torch.isfinite(poses.poses).all()), f"{name}: non-finite poses")
            print(f"  {name} request {i}{' (warm-up)' if i == 0 else ''}: stem {r.n_inputs} channels, "
                  f"K={est.cfg.n_pose_hypotheses}, {est.cfg.n_refiner_iterations} iterations; "
                  + " ".join(f"{k}_s={v:.4f}" for k, v in tm.items())
                  + (f"; depth valid {extra['depth_refiner']['valid'].tolist()}" if depth_stage else ""), flush=True)
        launches = rt.visibility_kernel.launches  # read right after the path
        expected = 2 * (len(launch_phases(len(dets), est.cfg)) + depth_stage)
        print(f"  {name}: kernel launches {launches} (expected {expected})", flush=True)
        check(launches == expected and ("depth_refiner" in tm) == depth_stage, f"{name}: launches or timing")
        total += launches
    return total


def jax_rerun(method: str) -> dict | None:
    """The JAX package's CPU rerun of demo_ar_baseline (per pass: poses and
    infos), or None where it is not in the copy."""
    path = JAX_AR_GNC / f"predictions_{method}.npz"
    if not path.exists():
        return None
    with np.load(path) as z:
        out = {}
        for stage in ("rgb", "depth"):
            scene, view = z[f"{stage}/scene_id"], z[f"{stage}/view_id"]
            frame = list(zip(scene.tolist(), view.tolist()))
            inst = np.asarray([frame[:i].count(f) for i, f in enumerate(frame)], np.int64)
            out[stage] = TensorCollection(
                infos={"label": z[f"{stage}/label"].astype(object), "scene_id": scene, "view_id": view,
                       "instance_id": inst, "score": np.ones(len(scene))},
                poses=torch.as_tensor(z[f"{stage}/poses"]))
    return out


def compare_depth_eval(method: str, tag: str, preds: dict, jax: dict, scene_ds, mesh_db) -> None:
    """The port's passes against the JAX rerun, per instance: instances
    within 0.1 degree and 0.1 mm; for the depth pass, the instances that
    start from the same RGB pose but end apart, with the depth stage's move
    in the JAX run; and the JAX poses scored by the port's meters."""
    rgb_same = None
    for stage in ("rgb", "depth"):
        a, b = preds[stage], jax[stage]
        check(a.labels == b.labels and a.infos["view_id"].tolist() == b.infos["view_id"].tolist(),
              f"{method}: instances differ from the JAX rerun")
        Pa, Pb = a.poses.double(), b.poses.double()
        deg = rot_deg(Pa, Pb)
        mm = (Pa[:, :3, 3] - Pb[:, :3, 3]).norm(dim=-1) * 1e3
        same = (deg <= 0.1) & (mm <= 0.1)
        sa, sb = instance_scores(a, scene_ds, mesh_db), instance_scores(b, scene_ds, mesh_db)
        n_scores = int((sa != sb).any(1).sum())
        print(f"    {tag} {method} {stage}: {int(same.sum())} of {len(same)} instances within 0.1 deg and 0.1 mm "
              f"of the JAX rerun; {n_scores} score otherwise; JAX poses scored here AR {sb.mean():.6f}",
              flush=True)
        if stage == "rgb":
            rgb_same = same
            continue
        R = jax["rgb"].poses.double()
        move_deg = rot_deg(R, Pb)
        move_mm = (R[:, :3, 3] - Pb[:, :3, 3]).norm(dim=-1) * 1e3
        for i in torch.nonzero(~same).flatten().tolist():
            cause = "the RGB pose already differs" if not rgb_same[i] else "same RGB start, the depth stage diverged"
            print(f"      instance {i} {a.labels[i]}: {deg[i]:.4f} deg {mm[i]:.4f} mm apart ({cause}); the JAX "
                  f"run's depth stage moved it {move_deg[i]:.2f} deg {move_mm[i]:.2f} mm", flush=True)


def phase_depth_eval() -> int:
    """The ported demo_ar_baseline on runs/ar_gnc/synthdemo with ICP and
    with GNC, as the committed reports were made."""
    trained = all((WEIGHTS / f).exists() for f in WEIGHT_FILES.values())
    weights = [f"coarse_weights={WEIGHTS / WEIGHT_FILES['coarse_dr']}",
               f"refiner_weights={WEIGHTS / WEIGHT_FILES['refiner_dr']}"] if trained else []
    dtypes = ("float32", "bfloat16") if trained else ("bfloat16",)
    print(f"  weights: {'coarse@5000, refiner@24000' if trained else 'seeded (no npz files in build/weights)'}; "
          f"dtypes {dtypes}", flush=True)
    committed = {m: json.loads((AR_GNC / f"report_{m}.json").read_text()) for m in ("icp", "gnc")}
    scene_ds = BOPDataset(AR_GNC / "synthdemo", load_depth=True)
    mesh_db = demo_ar_baseline.world_mesh_db(AR_GNC / "synthdemo", "cuda")
    launches = expected = 0
    rt.visibility_kernel.launches = 0  # the depth-eval path starts here
    runs = []
    for dtype in dtypes:
        for method in ("icp", "gnc"):
            args = demo_ar_baseline.parse_args([
                f"out_dir={AR_GNC}", "so3=64", "refine_iters=3", "n_hyp=4", f"depth_refine={method}",
                f"dtype={dtype}", "device=cuda", *weights])
            t0 = time.perf_counter()
            report, preds = demo_ar_baseline.run(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s, sd, c = report["summary"], report["summary_depth_refined"], committed[method]
            check(s["n"] == sd["n"] == 19, f"n={s['n']}, {sd['n']}, expected 19")
            frames = Counter(zip(preds["rgb"].infos["scene_id"].tolist(), preds["rgb"].infos["view_id"].tolist()))
            icfg = InferenceConfig(SO3_grid_size=64, n_refiner_iterations=3, n_pose_hypotheses=4, bsz_images=64,
                                   bsz_objects=16, max_detections=2)
            expected += sum(2 * len(launch_phases(d, icfg)) + 1 + 4 for d in frames.values())
            print(f"  {dtype} {method}: {wall:.2f} s; RGB AR {s['AR']:.6f} (committed {c['summary']['AR']:.6f}); "
                  f"{method.upper()} AR {sd['AR']:.6f} (committed {c['summary_depth_refined']['AR']:.6f}); "
                  f"AR_VSD/MSSD/MSPD {sd['AR_VSD']:.6f}/{sd['AR_MSSD']:.6f}/{sd['AR_MSPD']:.6f} (committed "
                  f"{c['summary_depth_refined']['AR_VSD']:.6f}/{c['summary_depth_refined']['AR_MSSD']:.6f}/"
                  f"{c['summary_depth_refined']['AR_MSPD']:.6f})", flush=True)
            runs.append((dtype, method, preds))
    launches = rt.visibility_kernel.launches  # read right after the path
    print(f"  kernel launches: {launches} (expected {expected}: two pipeline passes, one depth render and "
          f"four VSD renders per frame and run)", flush=True)
    check(launches == expected, "the depth eval did not launch the kernel as expected")
    for dtype, method, preds in runs:
        jax = jax_rerun(method) if trained else None
        if jax is None:
            print(f"  {dtype} {method}: no JAX rerun at these weights in {JAX_AR_GNC}: not compared", flush=True)
            continue
        compare_depth_eval(method, dtype, preds, jax, scene_ds, mesh_db)
    return launches

# ---------------------------------------------------------------------------
# Phase 13: training
# ---------------------------------------------------------------------------

TRAIN_RUNS = BUILD_DIR / "train_runs"
# Fields of a run's config.json that name the run rather than its model,
# data or optimizer; the training phase sets its own.
RUN_FIELDS = {"run_id", "run_dir", "seed", "resume_run_id", "pretrain_run_id", "train_datasets",
              "n_epochs", "save_epoch_interval", "val_epoch_interval", "n_max_objects"}


def run_overrides(run: str) -> list[str]:
    """`runs/<run>/config.json`'s model, data and optimizer settings as
    `key=value` arguments of `run_training`."""
    d = json.loads((ROOT / f"runs/{run}/config.json").read_text())
    fmt = lambda v: ",".join(map(str, v)) if isinstance(v, list) else str(v)
    return [f"{k}={fmt(v)}" for k, v in d.items() if k not in RUN_FIELDS]


def train_setup(run: str, **overrides):
    """(config, mesh DB, synthetic batches) of `run_training synthetic=1`
    with `runs/<run>/config.json`'s settings, on the card."""
    cfg = run_training.make_config(run.split("_")[0], False, run_overrides(run))
    cfg = dataclasses.replace(cfg, **overrides)
    mesh_db = run_training.synthetic_mesh_db(cfg, "cuda")
    return cfg, mesh_db, tt.synthetic_batch_fn(mesh_db, cfg.batch_size, tuple(cfg.input_resize), device="cuda")


def step_report(name: str, state, cfg, synth, mesh_db, n: int = 3) -> None:
    """Seconds per step over `n` steps after warm-up, each `tt.train_step`
    with its batch and draws made before it as `train` makes them, split
    into batch, forward, backward and optimizer by CUDA events recorded
    where the step enters and leaves `forward_loss` and enters
    `apply_gradients`; the traced busy and idle share of one more step,
    and the peak memory."""
    marks: list = []

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    def step():
        batch = synth(tt.step_generator(cfg.seed, tt.BATCH_STREAM, state.step))
        draws = tt.step_draws(cfg, batch, mesh_db, tt.DRAW_STREAM, state.step)
        tt.train_step(state, cfg, batch, mesh_db, draws, cfg.n_iterations)

    def timed() -> dict:
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark()
        step()
        mark()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        parts = ("batch", "forward", "backward", "optimizer")
        return {**{p: marks[i].elapsed_time(marks[i + 1]) / 1e3 for i, p in enumerate(parts)}, "wall": wall}

    forward, apply = tt.forward_loss, state.apply_gradients

    def marked_forward(*a, **k):
        mark()
        out = forward(*a, **k)
        mark()
        return out

    def marked_apply(*a, **k):
        mark()
        return apply(*a, **k)

    tt.forward_loss, state.apply_gradients = marked_forward, marked_apply
    torch.cuda.reset_peak_memory_stats()
    try:
        times = [timed() for _ in range(n)]
    finally:
        tt.forward_loss = forward
        del state.apply_gradients
    mean = {k: sum(t[k] for t in times) / n for k in times[0]}
    wall, busy, top, _ = profile_call(step)
    print(f"  {name} step (mean of {n} after warm-up): " + " ".join(f"{k}_s={v:.4f}" for k, v in mean.items())
          + f"; traced step wall_ms={wall:.2f} device_busy_ms={busy:.2f} idle_share={1 - busy / wall:.3f}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; top: {'; '.join(top)}", flush=True)


def read_log(run_dir: Path) -> list[dict]:
    return [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()]


def phase_training(errors: list[float]) -> tuple[int, dict]:
    """The trainer at the committed runs' full width: refiner_dr (10
    epochs of one step, a checkpoint, 2 more resumed) and coarse_dr (5
    steps) through `run_training synthetic=1`, with the kernel's launches
    counted; each one's step by part; K1 against its plain twin at the
    training launch shapes; one step through K1 against one through the
    plain twin; the card against the CPU at a small size; an overfit."""
    shutil.rmtree(TRAIN_RUNS, ignore_errors=True)
    common = ["synthetic=1", "device=cuda", f"run_dir={TRAIN_RUNS}", "save_epoch_interval=100",
              "val_epoch_interval=10"]
    refiner_args = ["config_id=refiner", *run_overrides("refiner_dr"), *common, "run_id=refiner"]
    coarse_args = ["config_id=coarse", *run_overrides("coarse_dr"), *common, "run_id=coarse"]

    rt.visibility_kernel.launches = 0  # the training path starts here
    t0 = time.perf_counter()
    state_r = run_training.main(refiner_args + ["n_epochs=10"])
    t_r = time.perf_counter() - t0
    state_r = run_training.main(refiner_args + ["n_epochs=12", "resume_run_id=refiner"])
    t0 = time.perf_counter()
    state_c = run_training.main(coarse_args + ["n_epochs=5"])
    t_c = time.perf_counter() - t0
    launches = rt.visibility_kernel.launches  # read right after the path
    cfg_r, cfg_c = load_config(TRAIN_RUNS / "refiner/config.json"), load_config(TRAIN_RUNS / "coarse/config.json")
    check(cfg_r.backbone_str == "resnet18-spatial" and cfg_r.batch_size == 32 and cfg_r.compute_dtype == "bfloat16"
          and tuple(cfg_r.render_size) == HW and cfg_r.n_rendered_views == 2 and cfg_r.n_iterations == 1,
          f"refiner not at the committed width: {cfg_r}")
    check(cfg_c.hypotheses_init_method == "coarse_classif_grid" and cfg_c.n_hypotheses == 4
          and cfg_c.batch_size == 32 and cfg_c.compute_dtype == "bfloat16", f"coarse not at the committed width: {cfg_c}")
    # Per step one observation render and one hypothesis render per
    # iteration; at epoch 10 two validation batches (forward only).
    per_step = 1 + cfg_r.n_iterations
    expected = 12 * per_step + tt.N_VAL_BATCHES * per_step + 5 * 2
    print(f"  kernel launches on the training path: {launches} (expected {expected})", flush=True)
    check(launches == expected, "the training path did not launch the kernel as expected")
    log_r, log_c = read_log(TRAIN_RUNS / "refiner"), read_log(TRAIN_RUNS / "coarse")
    check([l["epoch"] for l in log_r] == list(range(1, 13)) and state_r.step == 12, "refiner epochs or steps")
    check([l["epoch"] for l in log_c] == list(range(1, 6)) and state_c.step == 5, "coarse epochs or steps")
    check(all(np.isfinite(v) for l in log_r + log_c for v in l.values()), "non-finite training metrics")
    check("val_loss" in log_r[9] and (TRAIN_RUNS / "refiner/checkpoints/epoch_10/state.pt").exists()
          and (TRAIN_RUNS / "refiner/checkpoints/latest.txt").read_text() == "12", "validation or checkpoints")
    for name, log, t in (("refiner", log_r, t_r), ("coarse", log_c, t_c)):
        keys = [k for k in log[0] if k.startswith(("loss", "views", "grad"))]
        print(f"  {name}: {len(log)} epochs in {t:.2f} s (first epoch {log[0]['time_per_epoch']:.2f} s, "
              f"later {np.mean([l['time_per_epoch'] for l in log[2:]]):.4f} s); first / last "
              + " ".join(f"{k}={log[0][k]:.4g}/{log[-1][k]:.4g}" for k in keys), flush=True)
    print(f"  refiner resumed at epoch 11 from step 10: epochs {[l['epoch'] for l in log_r[10:]]}, "
          f"val_loss {log_r[9]['val_loss']:.4g}", flush=True)

    _, db, synth = train_setup("refiner_dr")
    step_report("refiner", state_r, cfg_r, synth, db)
    step_report("coarse", state_c, cfg_c, synth, db)
    shapes = train_kernel_shapes(state_r, state_c, cfg_r, cfg_c, db, synth, errors)
    del state_r, state_c
    train_kernel_vs_plain_step()
    train_card_vs_cpu()
    train_overfit()
    return launches, shapes


def train_kernel_shapes(state_r, state_c, cfg_r, cfg_c, db, synth, errors: list[float]) -> dict:
    """K1 at the training launch shapes, each held bit for bit against the
    plain twin and timed: the observations of a batch, the refiner's
    hypotheses and the coarse scorer's, from a fixed seed."""
    captured: list = []
    restore = record_visibility_inputs(captured)
    try:
        with torch.no_grad():
            batch = synth(torch.Generator().manual_seed(1))
            for cfg, state in ((cfg_r, state_r), (cfg_c, state_c)):
                draws = draws_to(draw_forward_loss(cfg, cfg.batch_size, db.points.shape[1],
                                                   torch.Generator().manual_seed(2)), "cuda")
                forward_loss(state.model, cfg, batch, db, draws, cfg.n_iterations)
    finally:
        rt.visibility = restore
    check(len(captured) == 3, f"captured {len(captured)} launches")
    shapes = {}
    for key, vis, per_step in zip(("obs", "refiner", "coarse"), captured, (1, cfg_r.n_iterations, 1)):
        g, per_launch = shape_group([vis], errors)
        key = f"train_{key}_B{vis[0].shape[0]}"
        shapes[key] = {**g, "launches": per_step}
        print(f"  {key}: launches_per_step={per_step} kernel_ms={g['ms']:.4f} plain_ms={g['plain_ms']:.3f} "
              f"bound_ms={g['bound_ms']:.4f} ({g['bound_by']}) max_abs_err={errors[-1]}", flush=True)
        print(tile_work_line(key, [vis]), flush=True)
    return shapes


def train_kernel_vs_plain_step() -> None:
    """One refiner step (f32, deterministic cuDNN, a fixed batch and
    draws) from the same weights, once through K1 and once with phase B
    on the plain twin: the loss and gradient norm to 1e-6 relative."""
    cfg, db, synth = train_setup("refiner_dr", compute_dtype="float32")
    batch = synth(torch.Generator().manual_seed(3))
    draws = draws_to(draw_forward_loss(cfg, cfg.batch_size, db.points.shape[1], torch.Generator().manual_seed(4)),
                     "cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for route in ("kernel", "plain"):
            state = tt.create_train_state(cfg, "cuda")
            restore = rt.visibility
            if route == "plain":
                rt.visibility = lambda *a: rt.visibility_plain(*a)
            try:
                metrics = tt.train_step(state, cfg, batch, db, draws, cfg.n_iterations)
            finally:
                rt.visibility = restore
            out[route] = (metrics, [p.detach().clone() for p in state.params])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (mk, pk), (mp, pp) = out["kernel"], out["plain"]
    rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in ("loss_total", "grad_norm")}
    dp = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    print(f"  step through K1 vs plain twin (f32): loss {mk['loss_total']:.8g} / {mp['loss_total']:.8g}, "
          f"grad_norm {mk['grad_norm']:.8g} / {mp['grad_norm']:.8g}, relative gaps {rel}; "
          f"largest parameter difference after the step {dp:.3g}", flush=True)
    check(all(v <= 1e-6 for v in rel.values()), f"kernel and plain steps differ: {rel}")


def train_card_vs_cpu() -> None:
    """forward_loss and its gradients on the card against the CPU at the
    CPU tests' size (tests/test_torch_forward_loss.py: resnet18-spatial,
    48x64 renders of 60x80 observations, batch 2, the 256-face cube and
    sphere, f32, TF32 off), from the same weights, batch and draws. Render
    pixels that differ between the devices (a silhouette pixel flipped by
    last-bit differences of the geometry) are counted, at most 0.1% of
    them. The loss is held to the CPU tests' rtol 1e-5 and each gradient
    tensor to within 1e-4 of its largest entry. The coarse scorer's
    gradients jump by a fixed amount where one ReLU or max-pool decision
    flips, so there a tensor may also differ by up to twice its own move
    on the CPU when the CPU's observation is scaled by 1 +- 2^-23; every
    tensor beyond 1e-4 is printed with that move."""
    objs = RigidObjectDataset([RigidObject(label="cube", mesh=mesh_io.make_cube(0.04)),
                               RigidObject(label="sphere", mesh=mesh_io.make_uv_sphere(0.035, 8, 12))])
    host_db = MeshDataBase.from_object_ds(objs, max_faces=256, n_points=128, n_sym=4)
    dbs = {d: host_db.batched(align=32, device=d) for d in ("cpu", "cuda")}
    base = TrainingConfig(backbone_str="resnet18-spatial", input_resize=(60, 80), render_size=(48, 64),
                          batch_size=2, n_points_loss=32, compute_dtype="float32")
    cases = {"refiner": (dataclasses.replace(make_refiner_cfg(base), n_rendered_views=2, multiview_type="front_1view",
                                             n_iterations=2, random_ambient_light=True), False),
             "coarse_grid": (dataclasses.replace(make_coarse_cfg(base), n_hypotheses=4), True)}
    for name, (cfg, ulp_room) in cases.items():
        batch = tt.synthetic_batch_fn(dbs["cpu"], 2, (60, 80), f=120.0, device="cpu")(torch.Generator().manual_seed(5))
        draws = draw_forward_loss(cfg, 2, 128, torch.Generator().manual_seed(6))

        def run(dev, scale=1.0):
            state = tt.create_train_state(cfg, dev)
            render, seen = state.model.render_views, []
            state.model.render_views = lambda *a, **k: seen.append(render(*a, **k)) or seen[-1]
            b = dataclasses.replace(batch, rgbs=batch.rgbs * scale).to(dev)
            loss, _ = forward_loss(state.model, cfg, b, dbs[dev], draws_to(draws, dev), cfg.n_iterations)
            grads = torch.autograd.grad(loss, state.params)
            names = [n for n, _ in state.model.named_parameters()]
            return loss.item(), dict(zip(names, (g.cpu() for g in grads))), [r.cpu() for r in seen]

        def gaps(a, b) -> dict:
            return {n: ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30)).item() for n in a}

        lg, gg, rg = run("cuda")
        lc, gc, rc = run("cpu")
        gap = gaps(gg, gc)
        move = {n: 0.0 for n in gap}
        if ulp_room:
            moves = [gaps(run("cpu", 1 + s * 2.0**-23)[1], gc) for s in (1, -1)]
            move = {n: max(m[n] for m in moves) for n in gap}
        limit = {n: max(1e-4, 2 * move[n]) for n in gap}
        flips = sum(int(((a - b).abs() > 1e-4).any(-1).sum()) for a, b in zip(rg, rc))
        pixels = sum(r[..., 0].numel() for r in rg)
        worst = max(gap, key=gap.get)
        beyond = ", ".join(f"{n} {gap[n]:.3g} (own 1-ulp move {move[n]:.3g})" for n in gap if gap[n] > 1e-4)
        print(f"  card vs cpu, {name}: {flips} of {pixels} rendered pixels differ; loss {lg:.8g} / {lc:.8g} "
              f"(relative {abs(lg - lc) / abs(lc):.3g}); worst relative gradient gap {gap[worst]:.3g} ({worst}) "
              f"over {len(gap)} tensors; beyond 1e-4: {beyond or 'none'}", flush=True)
        check(flips <= 0.001 * pixels and abs(lg - lc) <= 1e-5 * abs(lc) and all(gap[n] <= limit[n] for n in gap),
              f"{name}: card and cpu differ")


def train_overfit(n: int = 40) -> None:
    """The refiner at full width on one fixed batch with fixed draws, large
    initial noise and lr 1e-3 (tests/test_training.py's overfit check): the
    mean of the last 5 losses below the mean of the first 3."""
    cfg, db, synth = train_setup("refiner_dr", lr=1e-3, n_epochs_warmup=1,
                                 init_euler_deg_std=(40.0, 40.0, 40.0), init_trans_std=(0.04, 0.04, 0.12))
    batch = synth(torch.Generator().manual_seed(7))
    draws = draws_to(draw_forward_loss(cfg, cfg.batch_size, db.points.shape[1], torch.Generator().manual_seed(8)),
                     "cuda")
    state = tt.create_train_state(cfg, "cuda")
    t0 = time.perf_counter()
    losses = [tt.train_step(state, cfg, batch, db, draws, cfg.n_iterations)["loss_total"] for _ in range(n)]
    print(f"  overfit, {n} steps in {time.perf_counter() - t0:.2f} s: first 3 mean {np.mean(losses[:3]):.5g}, "
          f"last 5 mean {np.mean(losses[-5:]):.5g}; losses {' '.join(f'{l:.4g}' for l in losses)}", flush=True)
    check(all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:3]), "the overfit loss did not fall")




# ---------------------------------------------------------------------------
# Phase 14: the production configuration (fused, as a CUDA graph)
# ---------------------------------------------------------------------------

BENCH_HW = (480, 640)
BENCH_K = np.asarray([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float32)


def bench_world():
    """The JAX bench's world: a 40x40 UV sphere (obj1) and a cube (obj2) in
    a 3200-face database and a 768-face LOD database, 1000 points, 8
    symmetries."""
    objects = RigidObjectDataset([
        RigidObject(label="obj1", mesh=mesh_io.make_uv_sphere(0.05, 40, 40)),
        RigidObject(label="obj2", mesh=mesh_io.make_cube(0.04)),
    ])
    db, lod = (MeshDataBase.from_object_ds(objects, max_faces=f, n_points=1000, n_sym=8).batched(
        align=128, device="cuda") for f in (3200, 768))
    return db, lod


def bench_request(n_det: int = 8):
    """The JAX bench's request: a textured disc at 480x640 built on the
    host, and `n_det` boxes of obj1 around the image centre."""
    yy, xx = np.mgrid[0:BENCH_HW[0], 0:BENCH_HW[1]].astype(np.float32)
    disc = (((xx - 320.0) ** 2 + (yy - 240.0) ** 2) < 55.0**2).astype(np.float32)
    tex = 0.5 + 0.25 * np.sin(xx * 0.37) * np.cos(yy * 0.29)
    img = np.stack([disc * tex, disc * 0.5 * tex, disc * 0.25], -1)
    obs = ObservationTensor(torch.as_tensor(img[None], device="cuda"),
                            torch.as_tensor(BENCH_K[None], device="cuda"))
    half = 600 * 0.05 / 0.55
    rng = np.random.RandomState(0)
    cx = 320 + rng.uniform(-40, 40, size=n_det)
    cy = 240 + rng.uniform(-30, 30, size=n_det)
    boxes = np.stack([cx - half, cy - half, cx + half, cy + half], axis=1).astype(np.float32)
    return obs, make_detections(["obj1"] * n_det, boxes, device="cuda")


def first_weights(*names: str) -> Path | None:
    """The first of `build/weights/<name>` that exists."""
    return next((WEIGHTS / n for n in names if (WEIGHTS / n).exists()), None)


def production_model(run: str, *weights: str, seed: int):
    """A model of `runs/<run>/config.json`, with the first of the npz
    `weights` that exists or weights from `seed`."""
    path = first_weights(*weights)
    return build_model(ROOT / f"runs/{run}", path, None, seed=seed, device="cuda"), path


PRODUCTION = InferenceConfig(
    SO3_grid_size=576, SO3_prune_grid_size=144, SO3_prune_keep=16, n_refiner_iterations=5,
    n_pose_hypotheses=2, bsz_images=192, bsz_objects=16, max_detections=8, fused_pipeline=True,
)


def production_launches(cfg: InferenceConfig, n_children: int) -> dict[str, int]:
    """K1 launches of one fused request by phase: the probe sweep, the
    children sweep, the refiner (one per chunk and iteration) and the
    rescore."""
    D = cfg.max_detections
    chunk = min(cfg.bsz_images, D * cfg.SO3_grid_size)
    probe = D * cfg.SO3_prune_grid_size
    children = D * min(cfg.SO3_prune_keep, cfg.SO3_prune_grid_size) * n_children
    n_r = -(-D * cfg.n_pose_hypotheses // cfg.bsz_objects)
    return {"probe": -(-probe // min(chunk, probe)), "children": -(-children // min(chunk, children)),
            "refiner": n_r * cfg.n_refiner_iterations, "rescore": n_r}


def padded_inputs(est, obs, dets):
    """The fused mode's arguments of a request (`PoseEstimator.fused_inputs`)."""
    cfg = est.cfg
    return est.fused_inputs(obs.images.float(), obs.K.float(), dets.bboxes.float(),
                            est.mesh_db.label_to_index(dets.labels), cfg.n_refiner_iterations, cfg.n_pose_hypotheses)


def poses_close(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(largest rotation difference in degrees, largest translation
    difference in mm)."""
    return rot_deg(a, b).max().item(), (a[..., :3, 3] - b[..., :3, 3]).abs().max().item() * 1000


def phase_production(errors: list[float]) -> tuple[int, dict]:
    """The JAX bench's headline request rebuilt in the port, fused through
    a CUDA graph; its K1 launches (per request: the graph's recorded
    launches, which every replay launches again), K1 at the new launch
    shapes, replay against an eager run, fused against phased, and one
    request of each of the other options."""
    from megapose6d_tpu_torch.inference.pose_estimator import _GraphedPipeline

    db, lod = bench_world()
    check((db.faces.shape[1], lod.faces.shape[1]) == (3200, 768), f"faces {db.faces.shape} {lod.faces.shape}")
    coarse, c_w = production_model("coarse120", "coarse120@3000.npz", seed=0)
    refiner, r_w = production_model("refiner_dr", WEIGHT_FILES["refiner_dr"], "refiner_long@14000.npz", seed=1)
    check(tuple(coarse.cfg.render_size) == (120, 160) and coarse.cfg.compute_dtype == "bfloat16", str(coarse.cfg))
    print(f"  weights: coarse120 {c_w.name if c_w else 'seeded'}, refiner {r_w.name if r_w else 'seeded'}",
          flush=True)
    obs, dets = bench_request()
    est = PoseEstimator(coarse, refiner, db, PRODUCTION, device="cuda", mesh_db_coarse=lod)
    n_children = est.prune_children.shape[1]
    expected = production_launches(PRODUCTION, n_children)
    per_request = sum(expected.values())

    rt.visibility_kernel.launches = 0  # the production path starts here
    t0 = time.perf_counter()
    poses, extra = est.run_inference_pipeline(obs, dets)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    check(len(est._graphs) == 1, "one graph")
    graph: _GraphedPipeline = next(iter(est._graphs.values()))
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        poses, extra = est.run_inference_pipeline(obs, dets)
        walls.append(time.perf_counter() - t0)
    counted = rt.visibility_kernel.launches  # read right after the production path
    launches = counted - graph.kernel_launches + graph.replays * graph.kernel_launches
    print(f"  first request (warm-up, capture, replay): {capture_s:.3f} s; then {len(walls)} requests: "
          f"mean_s={np.mean(walls):.5f} median_s={np.median(walls):.5f} min_s={min(walls):.5f} "
          f"timing_total_s={extra['timing']['total']:.5f}", flush=True)
    print(f"  K1 per request: {graph.kernel_launches} recorded in the graph (expected {per_request}: "
          f"{expected}); wrapper count {counted} (one warm-up run and the capture); executed: "
          f"1 warm-up + {graph.replays} replays = {launches}", flush=True)
    check(graph.kernel_launches == per_request and counted == 2 * per_request,
          "the production path did not launch K1 as expected")
    P = poses.poses
    check(tuple(P.shape) == (8, 4, 4) and bool(torch.isfinite(P).all()), "bad poses")
    check(set(extra["timing"]) == {"total"}, f"fused timing {extra['timing']}")
    check(tuple(extra["coarse"]["logits"].shape) == (8, 16 * n_children), "pruned logits shape")
    in_grid = (extra["coarse"]["TCO_init"][..., :3, :3].reshape(-1, 1, 9)
               - est.so3_grid.reshape(1, -1, 9)).abs().amax(-1).amin(-1)
    print(f"  pruned hypotheses: {extra['coarse']['logits'].shape[1]} per detection, "
          f"-inf slots {int(torch.isinf(extra['coarse']['logits']).sum())}, all rotations in the 576 grid "
          f"(max |R - grid| {in_grid.max().item():.3g})", flush=True)

    with torch.inference_mode():
        args, inputs = padded_inputs(est, obs, dets)
        replay = {k: v.clone() for k, v in est.fused(*args, *inputs).items()}
        eager = est.pipeline(*args, *inputs)
        same = all(torch.equal(replay[k], eager[k]) for k in eager)
        diff = max((replay[k].float() - eager[k].float()).abs().nan_to_num(0.0).max().item() for k in eager)
        print(f"  graph replay vs eager run of the same function: bit-identical={same} (max diff {diff:.3g})",
              flush=True)
        check(same, "the graph replay differs from the eager run")
        # K1 at every launch of one request, through the eager run's inputs.
        captured: list = []
        restore = record_visibility_inputs(captured)
        try:
            est.pipeline(*args, *inputs)
        finally:
            rt.visibility = restore
    check(len(captured) == per_request, f"recorded {len(captured)} launches")
    shapes, i = {}, 0
    for phase, n in expected.items():
        group = captured[i : i + n]
        i += n
        g, _ = shape_group(group, errors)
        coefs, ids = group[0][0], group[0][1]
        key = f"prod_{phase}_B{coefs.shape[0]}_{group[0][3][0]}x{group[0][3][1]}_F{coefs.shape[1]}"
        shapes[key] = g
        print(f"  {key}: launches_per_request={n} kernel_ms={g['ms']:.4f} plain_ms={g['plain_ms']:.3f} "
              f"bound_ms={g['bound_ms']:.4f} ({g['bound_by']}) max_abs_err={max(errors[-n:])}", flush=True)
        print(tile_work_line(key, group), flush=True)

    # The request's device time inside a replay, and its idle share.
    wall, busy, top, traced_k1 = profile_call(lambda: est.run_inference_pipeline(obs, dets))
    print(f"  traced replay request: wall_ms={wall:.2f} device_busy_ms={busy:.2f} "
          f"idle_share={(1 - busy / wall) if busy else float('nan'):.3f}; K1 launches in the trace {traced_k1}; "
          f"top: {'; '.join(top)}", flush=True)
    check(traced_k1 == graph.kernel_launches, f"the replay's trace shows {traced_k1} K1 launches, "
          f"the graph recorded {graph.kernel_launches}")
    launches += graph.kernel_launches  # the traced request replayed the graph once more

    phased = PoseEstimator(coarse, refiner, db, dataclasses.replace(PRODUCTION, fused_pipeline=False),
                           device="cuda", mesh_db_coarse=lod)
    before = rt.visibility_kernel.launches
    phased.run_inference_pipeline(obs, dets)  # warm-up
    t0 = time.perf_counter()
    p_poses, p_extra = phased.run_inference_pipeline(obs, dets)
    p_wall = time.perf_counter() - t0
    pw, pbusy, _, _ = profile_call(lambda: phased.run_inference_pipeline(obs, dets))
    launches += rt.visibility_kernel.launches - before
    deg, mm = poses_close(poses.poses, p_poses.poses)
    dl = (poses.pose_logit - p_poses.pose_logit).abs().max().item()
    print(f"  phased, same configuration: wall_s={p_wall:.5f} ({', '.join(f'{k}_s={v:.4f}' for k, v in p_extra['timing'].items())}); "
          f"traced wall_ms={pw:.2f} device_busy_ms={pbusy:.2f} idle_share={(1 - pbusy / pw) if pbusy else float('nan'):.3f}; "
          f"fused vs phased: rot {deg:.3g} deg, trans {mm:.3g} mm, logit {dl:.3g}", flush=True)
    check(deg < 0.1 and mm < 0.1 and dl < 0.05, "fused and phased poses differ")

    # One request of each of the other options.
    coarse_dr, cd_w = production_model("coarse_dr", WEIGHT_FILES["coarse_dr"], "coarse_grid@2500.npz", seed=0)
    with torch.inference_mode():
        variants = {
            "unpruned 576 sweep, LOD": (coarse, dict(SO3_prune_grid_size=0), {}),
            "coarse_render_size=(120,160), coarse_dr scorer": (coarse_dr, dict(coarse_render_size=(120, 160)), {}),
            "rescore_f32": (coarse, dict(rescore_f32=True), {}),
            "keep_all_coarse_outputs": (coarse, {}, dict(keep_all_coarse_outputs=True)),
        }
        for name, (model, cfg_kw, call_kw) in variants.items():
            v_est = PoseEstimator(model, refiner, db, dataclasses.replace(PRODUCTION, **cfg_kw), device="cuda",
                                  mesh_db_coarse=lod)
            before = rt.visibility_kernel.launches
            t0 = time.perf_counter()
            v_poses, v_extra = v_est.run_inference_pipeline(obs, dets, **call_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            g = next(iter(v_est._graphs.values()))
            launches += rt.visibility_kernel.launches - before - g.kernel_launches + g.replays * g.kernel_launches
            check(bool(torch.isfinite(v_poses.poses).all()), f"{name}: poses")
            note = ""
            if call_kw.get("keep_all_coarse_outputs"):
                check(torch.equal(v_extra["coarse"]["all_TCO"], v_extra["coarse"]["TCO_init"]), "all_TCO")
                note = f" all_TCO {tuple(v_extra['coarse']['all_TCO'].shape)}"
            if cfg_kw.get("rescore_f32"):
                check(v_est.coarse_model_rescore.cfg.compute_dtype == "float32"
                      and v_est.coarse_model_rescore.backbone is coarse.backbone, "f32 twin")
            if cfg_kw.get("coarse_render_size"):
                check(v_est.coarse_model_sweep.cfg.render_at == (120, 160), "render_at twin")
                rec: list = []
                restore = record_visibility_inputs(rec)
                v_args, v_inputs = padded_inputs(v_est, obs, dets)
                try:
                    v_est.pipeline(*v_args, *v_inputs)
                finally:
                    rt.visibility = restore
                g2, _ = shape_group(rec[:1], errors)
                key = f"prod_render_at_B{rec[0][0].shape[0]}_{rec[0][3][0]}x{rec[0][3][1]}_F{rec[0][0].shape[1]}"
                at_shape = sum((r[0].shape, r[3]) == (rec[0][0].shape, rec[0][3]) for r in rec)
                shapes[key] = {**g2, "launches": at_shape}  # per request, at this shape
                note = (f" weights {cd_w.name if cd_w else 'seeded'}; first sweep launch {key} "
                        f"({at_shape} launches a request at this shape): "
                        f"kernel_ms={g2['ms']:.4f} bound_ms={g2['bound_ms']:.4f}")
            print(f"  {name}: capture request {wall:.3f} s, K1 per request {g.kernel_launches}, "
                  f"best logit mean {v_poses.pose_logit.mean().item():.4f}{note}", flush=True)

        # External initial poses: the production request's poses, refined again.
        ext = PoseEstimator(coarse, refiner, db, dataclasses.replace(
            PRODUCTION, coarse_estimation_type="external", fused_pipeline=False), device="cuda", mesh_db_coarse=lod)
        e_dets = TensorCollection(infos=dets.infos, bboxes=dets.bboxes, TCO_init=poses.poses)
        before = rt.visibility_kernel.launches
        e_poses, e_extra = ext.run_inference_pipeline(obs, e_dets)
        launches += rt.visibility_kernel.launches - before
        check(tuple(e_extra["refiner"]["trajectory"].shape) == (5, 8, 4, 4)
              and bool(torch.isfinite(e_poses.poses).all()), "external init")
        print(f"  external initial poses: timing {json.dumps({k: round(v, 4) for k, v in e_extra['timing'].items()})}",
              flush=True)
    return launches, shapes


# ---------------------------------------------------------------------------
# Phase 15: demo_finalize_pipeline
# ---------------------------------------------------------------------------

FINAL_WEIGHTS = {"refiner_dir": "refiner_long@14000.npz", "coarse_dir": "coarse_grid@2500.npz",
                 "coarse2_weights": "coarse120@3000.npz"}
FINAL_REPORTS = sorted((ROOT / "runs").glob("final_pipeline*/report.json"))


def flat_numbers(d: dict, prefix: str = "") -> dict[str, float]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_numbers(v, key))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = float(v)
    return out


def phase_demo_finalize() -> int:
    """The ported demo_finalize_pipeline on the card with the committed
    runs' settings: every report number finite and, with the trained
    weights, beside the committed reports' numbers."""
    from megapose6d_tpu_torch.scripts import demo_finalize_pipeline as dfp

    trained = all((WEIGHTS / w).exists() for w in FINAL_WEIGHTS.values())
    args = dfp.parse_args([
        "so3=576", f"n_eval={32 if trained else 16}", "refine_iters=3", "lod_ab=1", "coarse_res_ab=1",
        "prune_ab=1", "prune_grid=144", "prune_keep=16", f"coarse2_dir={ROOT / 'runs/coarse120'}",
        "combo_ab=1", "combo_top_k=2", f"out_dir={BUILD_DIR / 'demo_finalize'}",
    ])
    if trained:
        args.update({k: str(WEIGHTS / w) for k, w in FINAL_WEIGHTS.items()})
    else:
        args.update(refiner_dir="", coarse_dir="", coarse_steps="0")  # seeded, no training
    print(f"  weights: {'trained ' + json.dumps(FINAL_WEIGHTS) if trained else 'seeded'}; n_eval={args['n_eval']}",
          flush=True)
    rt.visibility_kernel.launches = 0  # the demo's path starts here
    t0 = time.perf_counter()
    report = dfp.run(args)
    wall = time.perf_counter() - t0
    launches = rt.visibility_kernel.launches  # read right after the demo
    numbers = flat_numbers(report)
    check(all(np.isfinite(v) for v in numbers.values()), "a report number is not finite")
    want = ("init", "refined", "pipeline", "lod_ab", "prune_ab", "coarse_res_ab", "coarse_small_ab", "combo_ab")
    check(all(report.get(k) for k in want), f"report incomplete: {[k for k in want if not report.get(k)]}")
    print(f"  {wall:.2f} s, K1 launches {launches}; report: {json.dumps(report)}", flush=True)
    committed = {p.parent.name: flat_numbers(json.loads(p.read_text())) for p in FINAL_REPORTS}
    for key, v in numbers.items():
        there = {name: c[key] for name, c in committed.items() if key in c}
        if there:
            print(f"  {key}: port {v:.6g}; committed (TPU, bf16) "
                  + ", ".join(f"{n} {x:.6g}" for n, x in there.items()), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 16: scene generation
# ---------------------------------------------------------------------------

SYNTHDEMO = EVAL_DATA / "synthdemo"  # demo_ar_baseline's dataset, committed (made on a TPU)
# The JAX package's generate_bop of the same frames on a CPU (written where
# the JAX package is installed, as README.md says; never committed).
JAX_SYNTHDEMO = ROOT / "build/jax_synthdemo"


def bop_tree_diff(ref: Path, mine: Path) -> dict:
    """The port's BOP tree against `ref`, frame by frame: the instance
    lists must be equal; the largest differences of scene_gt's rotations
    and translations (mm) and of scene_camera's K; per frame the share of
    pixels whose rgb is off by more than one level and of pixels whose
    depth is off by more than one mm, and the largest of each; the
    smallest mask_visib IoU of an instance."""
    d = dict(frames=0, instances=0, R=0.0, t_mm=0.0, K=0.0, rgb_share=[], rgb_max=0, depth_share=[],
             depth_max=0, iou_min=1.0)
    for scene in sorted(p.name for p in (mine / "test").iterdir() if p.is_dir()):
        a, b = ref / "test" / scene, mine / "test" / scene
        load = lambda root, f: json.loads((root / f"{f}.json").read_text())
        ga, gb, ca, cb = load(a, "scene_gt"), load(b, "scene_gt"), load(a, "scene_camera"), load(b, "scene_camera")
        check(set(gb) <= set(ga), f"{scene}: views {sorted(set(gb) - set(ga))} not in {ref}")
        for v in gb:
            check([r["obj_id"] for r in ga[v]] == [r["obj_id"] for r in gb[v]], f"{scene}/{v}: instances differ")
            for ra, rb in zip(ga[v], gb[v]):
                d["R"] = max(d["R"], float(np.abs(np.subtract(ra["cam_R_m2c"], rb["cam_R_m2c"])).max()))
                d["t_mm"] = max(d["t_mm"], float(np.abs(np.subtract(ra["cam_t_m2c"], rb["cam_t_m2c"])).max()))
            d["K"] = max(d["K"], float(np.abs(np.subtract(ca[v]["cam_K"], cb[v]["cam_K"])).max()))
            name = f"{int(v):06d}.png"
            rgb = np.abs(read_png(a / "rgb" / name).astype(int) - read_png(b / "rgb" / name).astype(int))
            dep = np.abs(read_png(a / "depth" / name).astype(int) - read_png(b / "depth" / name).astype(int))
            d["rgb_share"].append(float((rgb > 1).any(-1).mean()))
            d["depth_share"].append(float((dep > 1).mean()))
            d["rgb_max"], d["depth_max"] = max(d["rgb_max"], int(rgb.max())), max(d["depth_max"], int(dep.max()))
            for n in range(len(gb[v])):
                ma = read_png(a / "mask_visib" / f"{int(v):06d}_{n:06d}.png") > 0
                mb = read_png(b / "mask_visib" / f"{int(v):06d}_{n:06d}.png") > 0
                d["iou_min"] = min(d["iou_min"], float((ma & mb).sum() / max((ma | mb).sum(), 1)))
            d["frames"] += 1
            d["instances"] += len(gb[v])
    return d


def diff_line(name: str, d: dict) -> str:
    rs, ds = np.asarray(d["rgb_share"]), np.asarray(d["depth_share"])
    return (f"  {name}: {d['frames']} frames, {d['instances']} instances; max |dR| {d['R']:.3g}, |dt| {d['t_mm']:.3g} mm, "
            f"|dK| {d['K']:.3g}; rgb off by more than one level: mean share {rs.mean():.3g}, largest frame "
            f"{rs.max():.3g}, {int((rs > 0).sum())} frames with any, largest {d['rgb_max']} levels; depth off by "
            f"more than 1 mm: mean share {ds.mean():.3g}, largest frame {ds.max():.3g}, largest {d['depth_max']} mm; "
            f"smallest mask_visib IoU {d['iou_min']:.6f}")


def render_launches(render, keys) -> list:
    """The phase-B inputs of one render of `keys` (main pass, then shadow pass)."""
    captured: list = []
    restore = record_visibility_inputs(captured)
    try:
        render(keys)
    finally:
        rt.visibility = restore
    return captured


def kernel_at(name: str, launches: list, errors: list[float], shapes: dict) -> None:
    """K1 at a group of launches of one shape: bit for bit against the
    plain twin, timed beside the bound; recorded in `shapes`."""
    shape, per = shape_group(launches, errors)
    shapes[name] = shape
    print(f"  K1 {name}: B={launches[0][0].shape[0]} HxW={launches[0][3]} F={launches[0][0].shape[1]}: "
          f"kernel_ms={shape['ms']:.4f} plain_ms={shape['plain_ms']:.3f} bound_ms={shape['bound_ms']:.4f} "
          f"({shape['bound_by']}); max_abs_err 0", flush=True)
    print(tile_work_line(name, launches), flush=True)


def phase_scene_gen(errors: list[float]) -> tuple[int, dict]:
    """demo_ar_baseline's dataset regenerated by the port on the card and
    compared with the committed one; `generate` at its defaults into a
    webdataset shard, read back; K1 at both generators' shapes."""
    from megapose6d_tpu_torch.data.web_scene_dataset import WebSceneDataset
    from megapose6d_tpu_torch.scripts import generate_synthetic_dataset as gen

    shapes: dict = {}
    out_dir = BUILD_DIR / "scene_gen"
    shutil.rmtree(out_dir, ignore_errors=True)
    args = demo_ar_baseline.parse_args([f"out_dir={out_dir}", "n_frames=56", "device=cuda"])
    mesh_db, objects = worlds.build_bop_world("demo", "cuda")
    render = gen.SceneRenderer(mesh_db, 2, HW, 400.0)
    launches = render_launches(render, threefry.split(threefry.PRNGKey(123))[1])
    check(len(launches) == 2, f"{len(launches)} K1 launches for a scene, expected 2")
    kernel_at("datagen_main_B2", launches[:1], errors, shapes)
    kernel_at("datagen_shadow_B2", launches[1:], errors, shapes)

    rt.visibility_kernel.launches = 0  # the datagen path starts here
    t0 = time.perf_counter()
    demo_ar_baseline.generate_dataset(args, out_dir / "synthdemo", "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_datagen = rt.visibility_kernel.launches  # read right after the path
    print(f"  demo_ar_baseline datagen: 56 frames in {wall:.2f} s ({wall / 56:.4f} s per frame, PNGs included); "
          f"K1 launches {n_datagen} (expected 112: two passes per frame)", flush=True)
    check(n_datagen == 112, "the datagen did not launch K1 as expected")
    committed = bop_tree_diff(SYNTHDEMO, out_dir / "synthdemo")
    print(diff_line("against the committed runs/ar_dr/synthdemo (TPU)", committed), flush=True)
    check(committed["frames"] == 56 and committed["instances"] == 109, "frames or instances")
    check(committed["R"] <= 1e-6 and committed["t_mm"] <= 1e-3 and committed["K"] <= 1e-6, "scene_gt or scene_camera")
    check(np.mean(committed["rgb_share"]) <= 2e-3 and max(committed["rgb_share"]) <= 0.05
          and np.mean(committed["depth_share"]) <= 2e-3 and committed["iou_min"] >= 0.995,
          "the regenerated frames are not within the tolerance of the committed ones")
    if (JAX_SYNTHDEMO / "test").exists():
        jax_cpu = bop_tree_diff(JAX_SYNTHDEMO, out_dir / "synthdemo")
        print(diff_line(f"against the JAX package's frames on a CPU ({JAX_SYNTHDEMO.name})", jax_cpu), flush=True)
        check(np.mean(jax_cpu["rgb_share"]) <= 1e-4 and max(jax_cpu["rgb_share"]) <= 1e-3
              and jax_cpu["iou_min"] >= 0.999 and jax_cpu["depth_max"] <= 5, "not within the tolerance of JAX's")
    else:
        print(f"  no JAX CPU frames in {JAX_SYNTHDEMO}: not compared", flush=True)

    wds_db = MeshDataBase.from_object_ds(gen._default_objects()).batched(device="cuda")
    wds_render = gen.SceneRenderer(wds_db, 3, (480, 640), 600.0)
    wl = render_launches(wds_render, threefry.fold_in(threefry.PRNGKey(0), 0))
    kernel_at("generate_main_B3_480x640", wl[:1], errors, shapes)
    kernel_at("generate_shadow_B3_480x640", wl[1:], errors, shapes)
    rt.visibility_kernel.launches = 0  # the generate path starts here
    t0 = time.perf_counter()
    shards = gen.generate(wds_db, out_dir / "wds", n_frames=24, frames_per_shard=24)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_generate = rt.visibility_kernel.launches  # read right after the path
    ds = WebSceneDataset(out_dir / "wds", load_depth=True)
    n_obj = sum(len(ds[i].object_datas) for i in range(len(ds)))
    print(f"  generate (480x640, 3 objects, f=600): 24 frames in {wall:.2f} s ({wall / 24:.4f} s per frame); "
          f"{len(shards)} shard, read back {len(ds)} frames, {n_obj} objects; K1 launches {n_generate}", flush=True)
    check(len(shards) == 1 and len(ds) == 24 and ds[0].rgb.shape == (480, 640, 3) and n_obj >= 24
          and n_generate == 48, "generate's shard")
    return n_datagen + n_generate, shapes


# ---------------------------------------------------------------------------
# Phase 17: the detector
# ---------------------------------------------------------------------------

DETECTOR_RUN = ROOT / "runs/detector_long"
DETECTOR_NPZ = WEIGHTS / "detector_long@12000.npz"
DETECTOR_TRAIN = ["demo_world=1", "predict_masks=1", "batch_size=16", "n_steps=20", "ckpt_every=10",
                  "log_every=1"]


def detector_step_report(run, batch_fn, n: int = 3) -> None:
    """A detector training step split by CUDA events into the scene render
    (the draws on the host and both passes), forward and loss, backward
    and Adam, over `n` steps; the traced idle share of one more."""
    from megapose6d_tpu_torch.scripts import run_detector_training as rdt

    model = run.model.train()
    params = list(model.parameters())
    opt = tt.Adam(lambda count: 1e-4)
    state = opt.init(params)
    marks: list = []

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    def step(i: int):
        mark()
        batch = batch_fn(threefry.fold_in(threefry.PRNGKey(5), i))
        mark()
        loss, _ = rdt.losses(model, batch)
        mark()
        grads = torch.autograd.grad(loss, params)
        mark()
        opt.update(params, list(grads), state)
        mark()

    step(0)
    times = []
    for i in range(1, n + 1):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        times.append([marks[j].elapsed_time(marks[j + 1]) / 1e3 for j in range(4)] + [wall])
    mean = np.mean(times, 0)
    wall, busy, top, _ = profile_call(lambda: step(n + 1))
    print(f"  detector step (batch 16, 240x320, mean of {n}): " + " ".join(
        f"{k}_s={v:.4f}" for k, v in zip(("render", "forward", "backward", "adam", "wall"), mean))
        + f"; traced step wall_ms={wall:.2f} device_busy_ms={busy:.2f} idle_share={1 - busy / wall:.3f}; "
        f"top: {'; '.join(top)}", flush=True)


def phase_detector(errors: list[float]) -> tuple[int, dict]:
    """detector_long's configuration at 240x320 on the card against the CPU;
    run_detector_training (demo world, masks, batch 16) for 20 steps and
    resumed at step 10 from the same run, equal to the unbroken run; the
    step by part; K1 at the batch's shapes; evaluate_detector."""
    from megapose6d_tpu_torch.evaluation.evaluation import load_detector
    from megapose6d_tpu_torch.scripts import run_detector_training as rdt

    trained = DETECTOR_NPZ.exists()
    print(f"  weights: {DETECTOR_NPZ.name if trained else 'seeded (no npz in build/weights)'}", flush=True)
    card = load_detector(DETECTOR_RUN, DETECTOR_NPZ if trained else None, device="cuda")
    cpu = load_detector(DETECTOR_RUN, DETECTOR_NPZ if trained else None, device="cpu")
    scene_ds = BOPDataset(SYNTHDEMO)
    imgs = torch.as_tensor(np.stack([scene_ds[i].rgb for i in range(4)]).astype(np.float32) / 255.0)
    with torch.no_grad():
        a, b = card.model(imgs.to("cuda")), cpu.model(imgs)
    errs = {k: (a[k].cpu() - b[k]).abs().max().item() for k in b}
    scale = {k: b[k].abs().max().item() for k in b}
    print(f"  card vs CPU forward (4 committed frames, {tuple(card.model.cfg.__dict__.values())}): "
          + ", ".join(f"{k} max_abs_err {errs[k]:.3g} (of {scale[k]:.3g})" for k in b), flush=True)
    check(all(errs[k] <= 1e-4 * max(1.0, scale[k]) for k in b), "card and CPU detector forwards differ")

    runs = BUILD_DIR / "det_runs"
    shutil.rmtree(runs, ignore_errors=True)
    common = DETECTOR_TRAIN + [f"run_dir={runs}", "device=cuda"]
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        rt.visibility_kernel.launches = 0  # the detector training path starts here
        t0 = time.perf_counter()
        unbroken = rdt.main(common + ["run_id=unbroken"])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        # Resume halfway: the same run, its latest.txt moved back to step 10.
        shutil.copytree(runs / "unbroken", runs / "resumed")
        (runs / "resumed/checkpoints/latest.txt").write_text("10")
        log_lines = (runs / "resumed/log.txt").read_text().splitlines()
        (runs / "resumed/log.txt").write_text("\n".join(log_lines[:10]) + "\n")
        resumed = rdt.main(common + ["run_id=resumed"])
        launches = rt.visibility_kernel.launches  # read right after the path
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    print(f"  run_detector_training: 20 steps in {t_train:.2f} s, then 10 resumed from step 10; K1 launches "
          f"{launches} (expected 60: two passes per step)", flush=True)
    check(launches == 60 and unbroken.step == resumed.step == 20, "the detector training path")
    diff = max((x - y).abs().max().item() for x, y in zip(unbroken.model.state_dict().values(),
                                                          resumed.model.state_dict().values()))
    mdiff = max((x - y).abs().max().item() for k in ("mu", "nu")
                for x, y in zip(unbroken.opt_state[k], resumed.opt_state[k]))
    log = lambda r: [{k: v for k, v in json.loads(l).items() if k != "time"}
                     for l in (runs / r / "log.txt").read_text().splitlines()]
    print(f"  resumed vs unbroken: params max |diff| {diff:.3g}, Adam moments {mdiff:.3g}, logs equal "
          f"{log('resumed') == log('unbroken')}; loss first/last {log('unbroken')[0]['loss']:.4f}/"
          f"{log('unbroken')[-1]['loss']:.4f}", flush=True)
    check(diff == 0 and mdiff == 0 and log("resumed") == log("unbroken"), "the resumed run differs from the unbroken one")
    check(all(np.isfinite(v) for l in log("unbroken") for v in l.values()), "non-finite training metrics")

    mesh_db = MeshDataBase.from_object_ds(worlds.bop_world_objects("demo")).batched(device="cuda")
    batch_fn = rdt.DetectorBatches(mesh_db, 16, HW, 2, with_seg=True)
    shapes: dict = {}
    bl = render_launches(batch_fn.render, threefry.split(threefry.PRNGKey(9), 16))
    kernel_at("detector_train_main_B32", bl[:1], errors, shapes)
    kernel_at("detector_train_shadow_B32", bl[1:], errors, shapes)
    detector_step_report(unbroken, batch_fn)

    n_eval = 40 if trained else 4
    model = card.model
    rt.visibility_kernel.launches = 0  # the detector evaluation path starts here
    t0 = time.perf_counter()
    rep = rdt.evaluate_detector(model, batch_fn, n_eval, True, seed=777)
    wall = time.perf_counter() - t0
    n_eval_launches = rt.visibility_kernel.launches  # read right after the path
    want = json.loads((DETECTOR_RUN / "eval.json").read_text())
    print(f"  evaluate_detector ({n_eval} batches of 16, {wall:.2f} s, K1 launches {n_eval_launches}): "
          + ", ".join(f"{k} {v:.6g}" + (f" (committed {want[k]:.6g})" if trained else "") for k, v in rep.items()),
          flush=True)
    check(n_eval_launches == 2 * n_eval and all(np.isfinite(v) for v in rep.values()), "evaluate_detector")
    if trained:
        check(abs(rep["n_gt"] - want["n_gt"]) <= 0.005 * want["n_gt"]
              and all(abs(rep[k] - want[k]) <= 0.02 for k in want if k != "n_gt"),
              "evaluate_detector is not within 0.02 of the committed eval.json")
    return launches + n_eval_launches, shapes


# ---------------------------------------------------------------------------
# Phase 18: detector-driven serving and evaluation
# ---------------------------------------------------------------------------

COMMITTED_DET_EVAL = ROOT / "runs/full_eval/synthdemo.bop19/detector+SO3_grid"


def detections_vs_committed(port: dict, jax: dict, name: str = "the committed results.npz") -> bool:
    """The detector-driven predictions of both packages, row by row
    (scene, view, label, detection order): rows in both, the detector
    scores' and the final poses' differences there, rows in one only.
    True when both have the same rows."""
    keys = ("scene_id", "view_id", "label", "instance_id")
    rows = lambda tc: {r: i for i, r in enumerate(zip(*(tc.infos[k].tolist() for k in keys)))}
    a, b = rows(port["final"]), rows(jax["final"])
    both = sorted(set(a) & set(b))
    ia, ib = [a[r] for r in both], [b[r] for r in both]
    fa, fb = port["final"].poses[ia].double(), jax["final"].poses[ib].double()
    deg = rot_deg(fa, fb).numpy()
    mm = ((fa[:, :3, 3] - fb[:, :3, 3]).norm(dim=1) * 1e3).numpy()
    ds = np.abs(np.asarray(port["final"].infos["score"])[ia] - np.asarray(jax["final"].infos["score"])[ib])
    print(f"  per detection against {name}: {len(both)} rows in both, {len(a) - len(both)} "
          f"only in the port's, {len(b) - len(both)} only in the other; detector score |diff| max "
          f"{ds.max() if len(ds) else 0:.3g}; final poses within 1 degree and 1 mm: "
          f"{int(((deg < 1) & (mm < 1)).sum())} of {len(both)}, median {np.median(deg) if len(deg) else 0:.3f} deg "
          f"{np.median(mm) if len(mm) else 0:.3f} mm", flush=True)
    return len(both) == len(a) == len(b)


def serving_trained() -> bool:
    return DETECTOR_NPZ.exists() and all((WEIGHTS / f).exists() for f in WEIGHT_FILES.values())


def committed_det_eval() -> tuple[dict, InferenceConfig]:
    ecfg = json.loads((COMMITTED_DET_EVAL / "eval_config.json").read_text())
    return ecfg, InferenceConfig(**{k: v for k, v in ecfg["inference"].items() if k != "SO3_prune_keep"})


def detector_request() -> int:
    """One detector-driven request on a committed frame, phased, then
    fused (the detector before the CUDA graph)."""
    from megapose6d_tpu_torch.evaluation.evaluation import load_detector

    trained = serving_trained()
    weights = lambda run: str(WEIGHTS / WEIGHT_FILES[run]) if trained else ""
    print(f"  weights: {'trained (coarse@5000, refiner@24000, detector@12000)' if trained else 'seeded'}", flush=True)
    ecfg, icfg = committed_det_eval()
    coarse = build_model(ROOT / "runs/coarse_dr", weights("coarse_dr") or None, None, seed=0, device="cuda")
    refiner = build_model(ROOT / "runs/refiner_dr", weights("refiner_dr") or None, None, seed=1, device="cuda")
    detector = load_detector(DETECTOR_RUN, DETECTOR_NPZ if trained else None, device="cuda")
    mesh_db = MeshDataBase.from_object_ds(make_object_dataset("synthdemo.bop19", data_dir=EVAL_DATA),
                                          max_faces=ecfg["max_faces"]).batched(device="cuda")
    frame = BOPDataset(SYNTHDEMO)[1]
    obs = ObservationTensor.from_numpy(frame.rgb, frame.camera_data.K, device="cuda")
    phased = PoseEstimator(coarse, refiner, mesh_db, icfg, device="cuda", detector=detector)
    fused = PoseEstimator(coarse, refiner, mesh_db, dataclasses.replace(icfg, fused_pipeline=True), device="cuda",
                          detector=detector)
    rt.visibility_kernel.launches = 0  # the detector-driven request path starts here
    for _ in range(2):
        out_p, extra_p = phased.run_inference_pipeline(obs, run_detector=True)
    n_phased = rt.visibility_kernel.launches
    D = len(out_p)
    timing = extra_p["timing"]
    print(f"  phased request ({D} detections): " + " ".join(f"{k}_s={v:.4f}" for k, v in timing.items())
          + f"; K1 launches {n_phased // 2} per request", flush=True)
    check(n_phased == 2 * len(launch_phases(D, icfg)) and "detector" in timing, "the phased detector request")
    t0 = time.perf_counter()
    fused.run_inference_pipeline(obs, run_detector=True)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out_f, extra_f = fused.run_inference_pipeline(obs, run_detector=True)
        walls.append(time.perf_counter() - t0)
    counted = rt.visibility_kernel.launches - n_phased  # the wrapper counts the warm-up and the capture
    graph = next(iter(fused._graphs.values()))
    deg, mm = poses_close(out_f.poses, out_p.poses)
    # Seeded detectors give boxes of a few pixels: objects metres away, so
    # the translation is held relative to the distance (0.1 mm at 1 m).
    rel = ((out_f.poses[:, :3, 3] - out_p.poses[:, :3, 3]).norm(dim=1)
           / out_p.poses[:, :3, 3].norm(dim=1)).max().item()
    dl = (out_f.pose_logit - out_p.pose_logit).abs().max().item()
    print(f"  fused: first request {capture_s:.3f} s (detector, warm-up, capture, replay), replayed "
          f"{', '.join(f'{w:.4f}' for w in walls)} s (detector {extra_f['timing']['detector']:.4f} s of the last); "
          f"K1 per request {graph.kernel_launches} in the graph, wrapper count {counted} (warm-up and capture); "
          f"fused vs phased {deg:.3g} deg {mm:.3g} mm ({rel:.3g} of the distance), logit {dl:.3g}", flush=True)
    check(counted == 2 * graph.kernel_launches, "the fused detector request did not launch K1 as expected")
    # Two calls of the detector, with cuDNN's deterministic algorithms
    # (`Detector.infer`): the same scores, bit for bit.
    check(out_f.labels == out_p.labels and np.array_equal(out_f.infos["score"], out_p.infos["score"])
          and bool(torch.isfinite(out_f.poses).all()), "the fused request's detections or poses")
    x = obs.images[..., :3].float()
    cudnn = torch.backends.cudnn
    fwd_ms = {}
    for det in (False, True):
        with torch.inference_mode(), cudnn.flags(enabled=True, benchmark=False, deterministic=det,
                                                 allow_tf32=cudnn.allow_tf32):
            fwd_ms[det] = cuda_ms(lambda: detector.model(x), reps=20, warmup=3)
            outs = [detector.model(x) for _ in range(2)]
        same = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
        print(f"  detector forward, cuDNN deterministic={det}: {fwd_ms[det]:.4f} ms; two calls bit for bit: {same}",
              flush=True)
    if trained:
        # bf16 convolutions in other cuDNN algorithms (eager against
        # captured): phase 14's tolerance. Seeded weights are held in f32
        # below.
        check(deg < 0.1 and rel < 1e-4 and dl < 0.05, "fused and phased detector-driven poses differ")
    # The detector's output fed to float32 twins of both models, phased and
    # fused, held with every weight: phase 14's 0.1 degree, and 1e-4 of the
    # distance. Both modes take one call's detections: two calls of the
    # detector differ in ulps (cuDNN's transposed convolutions), and the
    # seeded detector's boxes of a few pixels turn that into other crops
    # and, after the refiner, other hypotheses (171 degrees apart).
    dets = detector.get_detections(obs)
    again = detector.get_detections(obs)
    c32, r32 = coarse.twin(compute_dtype="float32"), refiner.twin(compute_dtype="float32")
    phased32 = PoseEstimator(c32, r32, mesh_db, icfg, device="cuda")
    fused32 = PoseEstimator(c32, r32, mesh_db, dataclasses.replace(icfg, fused_pipeline=True), device="cuda")
    before = rt.visibility_kernel.launches
    out_p32, _ = phased32.run_inference_pipeline(obs, dets)
    out_f32, _ = fused32.run_inference_pipeline(obs, dets)
    graph32 = next(iter(fused32._graphs.values()))
    n_f32 = rt.visibility_kernel.launches - before - 2 * graph32.kernel_launches  # the phased run's
    deg32, mm32 = poses_close(out_f32.poses, out_p32.poses)
    rel32 = ((out_f32.poses[:, :3, 3] - out_p32.poses[:, :3, 3]).norm(dim=1)
             / out_p32.poses[:, :3, 3].norm(dim=1)).max().item()
    print(f"  float32, one call's detections: fused vs phased {deg32:.3g} deg {mm32:.3g} mm ({rel32:.3g} of the "
          f"distance); two detector calls' boxes |diff| max {(again.bboxes - dets.bboxes).abs().max().item():.3g} px",
          flush=True)
    check(deg32 < 0.1 and rel32 < 1e-4, "float32 fused and phased poses from the detector's boxes differ")
    check(torch.equal(again.bboxes, dets.bboxes) and np.array_equal(again.infos["score"], dets.infos["score"]),
          "two detector calls on one image differ")
    return n_phased + (1 + graph.replays) * graph.kernel_launches + n_f32 + (1 + graph32.replays) * graph32.kernel_launches


# The JAX package's detector-driven run_eval of the first 4 frames on a CPU,
# both pose models in float32 at the committed steps (written where the JAX
# package is installed, as README.md says; never committed).
JAX_CPU_DET_EVAL = ROOT / "build/jax_det_eval_f32/synthdemo.bop19/detector+SO3_grid"


def detector_f32_vs_jax_cpu() -> int:
    """The detector-driven evaluation with both pose models in float32 on
    the card against the JAX package's float32 run of the same frames on a
    CPU, per detection and per instance (ROADMAP Queue 3, O1): where bf16
    on another device ends and a fault of the port would begin. Needs the
    three npz exports and `JAX_CPU_DET_EVAL`."""
    if not (serving_trained() and (JAX_CPU_DET_EVAL / "results.npz").exists()):
        print(f"  no float32 JAX CPU detector run in {JAX_CPU_DET_EVAL} (or no exports): not compared", flush=True)
        return 0
    ecfg, icfg = committed_det_eval()
    f32_runs = BUILD_DIR / "f32_runs"
    for run in ("coarse_dr", "refiner_dr"):
        d = json.loads((ROOT / "runs" / run / "config.json").read_text())
        (f32_runs / run).mkdir(parents=True, exist_ok=True)
        (f32_runs / run / "config.json").write_text(json.dumps({**d, "compute_dtype": "float32"}))
    jax = load_predictions(JAX_CPU_DET_EVAL / "results.npz")
    n_frames = len(set(zip(jax["final"].infos["scene_id"].tolist(), jax["final"].infos["view_id"].tolist())))
    cfg = EvalConfig(
        detector_run=str(DETECTOR_RUN), detector_weights=str(DETECTOR_NPZ), coarse_run=str(f32_runs / "coarse_dr"),
        refiner_run=str(f32_runs / "refiner_dr"), coarse_weights=str(WEIGHTS / WEIGHT_FILES["coarse_dr"]),
        refiner_weights=str(WEIGHTS / WEIGHT_FILES["refiner_dr"]), ds_name=ecfg["ds_name"], data_dir=str(EVAL_DATA),
        inference=icfg, save_dir=str(BUILD_DIR / "det_eval_f32"), n_frames=n_frames,
        render_size=tuple(ecfg["render_size"]), max_faces=ecfg["max_faces"], load_depth=True, device="cuda")
    shutil.rmtree(cfg.save_dir, ignore_errors=True)
    rt.visibility_kernel.launches = 0  # the float32 detector-driven evaluation starts here
    t0 = time.perf_counter()
    out = run_eval(cfg)
    wall = time.perf_counter() - t0
    launches = rt.visibility_kernel.launches  # read right after the path
    port = load_predictions(out["results_path"])
    jax_ar = json.loads((JAX_CPU_DET_EVAL / "summary.json").read_text())["bop"]["AR"]
    print(f"  float32 on the card, {n_frames} frames in {wall:.2f} s, K1 launches {launches}: AR "
          f"{out['summary']['bop']['AR']:.6f} (the JAX CPU float32 run: {jax_ar:.6f})", flush=True)
    if detections_vs_committed(port, jax, "the JAX package's float32 CPU run"):
        scene_ds = make_scene_dataset(cfg.ds_name, load_depth=True, data_dir=cfg.data_dir)
        mesh_db = MeshDataBase.from_object_ds(make_object_dataset(cfg.ds_name, data_dir=cfg.data_dir),
                                              max_faces=cfg.max_faces).batched(device="cuda")
        compare_runs("port f32 (card) vs jax f32 (cpu)", port, jax, instance_scores(port["final"], scene_ds, mesh_db),
                     instance_scores(jax["final"], scene_ds, mesh_db))
    return launches


def detector_full_eval() -> int:
    """run_full_eval as the committed detector+SO3_grid evaluation: all 56
    frames with the trained weights, else 8 seeded."""
    from megapose6d_tpu_torch.evaluation.eval_config import FullEvalConfig
    from megapose6d_tpu_torch.scripts.run_full_eval import run_full_eval

    trained = serving_trained()
    weights = lambda run: str(WEIGHTS / WEIGHT_FILES[run]) if trained else ""
    det_w = str(DETECTOR_NPZ) if trained else ""
    ecfg, icfg = committed_det_eval()
    save = BUILD_DIR / "full_eval"
    shutil.rmtree(save, ignore_errors=True)
    fcfg = FullEvalConfig(
        detector_run=str(DETECTOR_RUN), coarse_run=str(ROOT / ecfg["coarse_run"]),
        refiner_run=str(ROOT / ecfg["refiner_run"]), detector_weights=det_w, coarse_weights=weights("coarse_dr"),
        refiner_weights=weights("refiner_dr"), ds_names=[ecfg["ds_name"]], data_dir=str(EVAL_DATA), inference=icfg,
        detection_coarse_types=[("detector", "SO3_grid")], save_dir=str(save), n_frames=None if trained else 8,
        render_size=tuple(ecfg["render_size"]), max_faces=ecfg["max_faces"], load_depth=True, device="cuda")
    rt.visibility_kernel.launches = 0  # the full-eval path starts here
    t0 = time.perf_counter()
    summaries = run_full_eval(fcfg)
    wall = time.perf_counter() - t0
    n_full = rt.visibility_kernel.launches  # read right after the path
    s = summaries["synthdemo.bop19/detector+SO3_grid"]
    want = json.loads((COMMITTED_DET_EVAL / "summary.json").read_text())
    print(f"  run_full_eval ({'56' if trained else '8'} frames, {wall:.2f} s, K1 launches {n_full}): "
          f"{json.dumps(s)}", flush=True)
    if trained:
        print(f"  committed (TPU): AR {want['bop']['AR']:.6f} n_missed {want['modelnet']['n_missed']}; port AR "
              f"{s['bop']['AR']:.6f} n_missed {s['modelnet']['n_missed']}", flush=True)
        detections_vs_committed(load_predictions(save / "synthdemo.bop19/detector+SO3_grid/results.npz"),
                                load_predictions(COMMITTED_DET_EVAL / "results.npz"))
    check(n_full > 0 and s["bop"]["n"] > 0 and np.isfinite(s["bop"]["AR"])
          and (save / "all_summaries.json").exists(), "run_full_eval")
    return n_full


def detector_demo() -> int:
    """demo_ar_baseline detector_dir=: on runs/ar_dr beside its committed
    report with the trained weights, else seeded on the 10 frames of
    runs/ar_gnc."""
    trained = serving_trained()
    out_dir = EVAL_DATA if trained else AR_GNC
    args = demo_ar_baseline.parse_args([
        f"out_dir={out_dir}", f"report_dir={BUILD_DIR / 'ar_detector'}", "so3=576", "refine_iters=3", "n_hyp=4",
        f"detector_dir={DETECTOR_RUN}", "device=cuda"] + ([
            f"detector_weights={DETECTOR_NPZ}", f"coarse_weights={WEIGHTS / WEIGHT_FILES['coarse_dr']}",
            f"refiner_weights={WEIGHTS / WEIGHT_FILES['refiner_dr']}"] if trained else []))
    rt.visibility_kernel.launches = 0  # the demo's path starts here
    t0 = time.perf_counter()
    report, _ = demo_ar_baseline.run(args)
    wall = time.perf_counter() - t0
    n_demo = rt.visibility_kernel.launches  # read right after the path
    sd = report["summary_from_detector"]
    print(f"  demo_ar_baseline detector_dir on {out_dir.name}/synthdemo ({wall:.2f} s, K1 launches {n_demo}): "
          f"summary {json.dumps(report['summary'])}; summary_from_detector {json.dumps(sd)}", flush=True)
    if trained:
        c = json.loads((EVAL_DATA / "report.json").read_text())
        print(f"  committed runs/ar_dr/report.json (TPU): summary AR {c['summary']['AR']:.6f}, "
              f"summary_from_detector AR {c['summary_from_detector']['AR']:.6f}", flush=True)
    check(n_demo > 0 and sd is not None and np.isfinite(sd["AR"]), "demo_ar_baseline detector_dir")
    return n_demo


# ---------------------------------------------------------------------------
# Phase 19: dataset-fed training
# ---------------------------------------------------------------------------

DATASET_RUNS = BUILD_DIR / "dataset_runs"
BOP_TRAIN = ["train_datasets=synthdemo.bop19", f"data_dir={EVAL_DATA}", "object_dataset=synthdemo.bop19"]


def dataset_args(run: str, run_id: str, workers: int, *extra: str) -> list[str]:
    """`run_training` arguments at `runs/<run>/config.json`'s width, fed by
    the committed BOP set (phase 19's runs directory)."""
    return [f"config_id={run.split('_')[0]}", *run_overrides(run), *BOP_TRAIN, "device=cuda",
            f"run_dir={DATASET_RUNS}", f"run_id={run_id}", f"n_dataloader_workers={workers}",
            "save_epoch_interval=1000", *extra]


def dataset_step_report(name: str, state, cfg, loader, mesh_db, n: int = 5) -> None:
    """Seconds per step over `n` steps after two of warm-up, each as
    `train` runs it from the loader: the host's wait for the next batch
    (wall clock), then by CUDA events the copy to the card (the batch and
    the step's draws), forward, backward and Adam; the traced busy and idle
    share of one more step."""
    marks: list = []
    waits: list = []

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    def step():
        t0 = time.perf_counter()
        host = next(loader)
        waits.append(time.perf_counter() - t0)
        mark()
        batch = host.to("cuda", non_blocking=True)
        draws = tt.step_draws(cfg, batch, mesh_db, tt.DRAW_STREAM, state.step)
        tt.train_step(state, cfg, batch, mesh_db, draws, cfg.n_iterations)

    forward, apply = tt.forward_loss, state.apply_gradients

    def marked_forward(*a, **k):
        mark()
        out = forward(*a, **k)
        mark()
        return out

    def marked_apply(*a, **k):
        mark()
        return apply(*a, **k)

    def timed() -> dict:
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        mark()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        parts = ("h2d", "forward", "backward", "optimizer")
        return {"host_wait": waits[-1], **{p: marks[i].elapsed_time(marks[i + 1]) / 1e3 for i, p in enumerate(parts)},
                "wall": wall}

    tt.forward_loss, state.apply_gradients = marked_forward, marked_apply
    try:
        for _ in range(2):
            timed()
        times = [timed() for _ in range(n)]
    finally:
        tt.forward_loss = forward
        del state.apply_gradients
    mean = {k: sum(t[k] for t in times) / n for k in times[0]}
    wall, busy, top, _ = profile_call(step)
    print(f"  {name} step from the loader (mean of {n} after warm-up): "
          + " ".join(f"{k}_s={v:.4f}" for k, v in mean.items())
          + f"; traced step wall_ms={wall:.2f} device_busy_ms={busy:.2f} idle_share={1 - busy / wall:.3f}; "
          f"top: {'; '.join(top)}", flush=True)


def loader_rate(loader, n: int) -> float:
    """Batches per second of a started loader alone, over `n` batches."""
    t0 = time.perf_counter()
    for _ in range(n):
        next(loader)
    return n / (time.perf_counter() - t0)


def dataset_resume_check() -> None:
    """The refiner on the BOP set with the inline loader and deterministic
    cuDNN: 6 steps unbroken (a checkpoint at step 4), and the same run
    resumed from step 4: parameters, Adam and the logs bit for bit."""
    args = dataset_args("refiner_dr", "det_unbroken", 0, "n_epochs=6", "save_epoch_interval=4")
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        unbroken = run_training.main(args)
        wall = time.perf_counter() - t0
        shutil.copytree(DATASET_RUNS / "det_unbroken", DATASET_RUNS / "det_resumed")
        (DATASET_RUNS / "det_resumed/checkpoints/latest.txt").write_text("4")
        lines = (DATASET_RUNS / "det_resumed/log.txt").read_text().splitlines()
        (DATASET_RUNS / "det_resumed/log.txt").write_text("\n".join(lines[:4]) + "\n")
        resumed = run_training.main([a.replace("run_id=det_unbroken", "run_id=det_resumed") for a in args]
                                    + ["resume_run_id=det_resumed"])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    dp = max((a - b).abs().max().item() for a, b in zip(unbroken.params, resumed.params))
    dm = max((a - b).abs().max().item() for k in ("mu", "nu")
             for a, b in zip(unbroken.opt_state[k], resumed.opt_state[k]))
    log = lambda r: [{k: v for k, v in l.items() if k != "time_per_epoch"} for l in read_log(DATASET_RUNS / r)]
    print(f"  inline loader, deterministic cuDNN: 6 steps in {wall:.2f} s; resumed from step 4 vs unbroken: params "
          f"max |diff| {dp:.3g}, Adam moments {dm:.3g}, logs equal {log('det_resumed') == log('det_unbroken')}",
          flush=True)
    check(unbroken.step == resumed.step == 6 and dp == 0 and dm == 0 and log("det_resumed") == log("det_unbroken"),
          "the resumed dataset-fed run differs from the unbroken one")


def dataset_card_vs_cpu(errors: list[float], shapes: dict) -> None:
    """One batch of the BOP stream (inline loader) through a refiner step
    on the card and on the CPU, in f32 from the same weights and draws, at
    240x320 with 2 samples, stage by stage. The renders: the devices'
    last-bit differences in the geometry move a colour by up to ~1e-3
    where a texel edge lies under a pixel, and flip the face of a pixel on
    a face edge outright; at most 1e-4 of the pixels may differ by more
    than 1e-2. The observation crops: within 1e-4. Then the step given the
    card's renders and crops: the loss to 1e-4 relative and each gradient
    tensor within the larger of 1e-4 of its largest entry and twice its
    own move on either device when the crops are scaled by 1 +- 2^-23
    (phase 13's rule, at the network's input). At 240x320 a ReLU or
    max-pool decision flips under such an ulp, on the card as on the CPU
    (and under another CPU thread count), and moves a tensor's gradient by
    up to ~3% of its largest entry; the randomly initialised network also
    turns one flipped render pixel into a ~1e-3 move of the loss: hence
    the stages and the rule. Then K1 at this path's launches of a full
    batch of 32 (the refiner's 2 views, the coarse scorer's 4 hypotheses;
    no observation is rendered) bit for bit against the plain twin, and
    timed."""
    cfg = run_training.make_config("refiner", False, run_overrides("refiner_dr") + BOP_TRAIN[:1] + [
        "compute_dtype=float32", "batch_size=2", "n_dataloader_workers=0"])
    dbs = {d: run_training.dataset_mesh_db(cfg, "synthdemo.bop19", str(EVAL_DATA), d) for d in ("cuda", "cpu")}
    loader = run_training.dataset_loader(cfg, list(dbs["cpu"].labels), str(EVAL_DATA), "cpu")
    host = next(loader)
    loader.close()
    draws = draw_forward_loss(cfg, 2, dbs["cpu"].points.shape[1], torch.Generator().manual_seed(12))

    def run(dev, scale=1.0, given=None):
        """(loss, gradients, {stage: [outputs per call]}) of one step on
        `dev`; `given` replaces the renders and crops, call by call, the
        crops' images scaled by `scale`."""
        state = tt.create_train_state(cfg, dev)
        model, seen = state.model, {"renders": [], "crops": []}
        render, crop = model.render_views, model.crop_inputs

        def render_views(*a, **k):
            out = given["renders"][len(seen["renders"])].to(dev) if given else render(*a, **k)
            seen["renders"].append(out)
            return out

        def crop_inputs(*a, **k):
            if given:
                images, *rest = given["crops"][len(seen["crops"])]
                out = ((images * scale).to(dev), *(t.to(dev) for t in rest))
            else:
                out = crop(*a, **k)
            seen["crops"].append(out)
            return out

        model.render_views, model.crop_inputs = render_views, crop_inputs
        loss, _ = forward_loss(model, cfg, host.to(dev), dbs[dev], draws_to(draws, dev), cfg.n_iterations)
        grads = torch.autograd.grad(loss, state.params)
        names = [n for n, _ in model.named_parameters()]
        kept = {"renders": [r.detach().cpu() for r in seen["renders"]],
                "crops": [tuple(t.detach().cpu() for t in c) for c in seen["crops"]]}
        return loss.item(), dict(zip(names, (g.cpu() for g in grads))), kept

    def gaps(a, b) -> dict:
        return {n: ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30)).item() for n in a}

    lg, gg, card = run("cuda")
    _, _, own = run("cpu")
    d = torch.cat([(a - b).abs().amax(-1).flatten() for a, b in zip(card["renders"], own["renders"])])
    dcrop = max((a[0] - b[0]).abs().max().item() for a, b in zip(card["crops"], own["crops"]))
    lc, gc, _ = run("cpu", given=card)
    gg = run("cuda", given=card)[1]
    moves = [gaps(run(dev, 1 + s * 2.0**-23, given=card)[1], g0) for dev, g0 in (("cuda", gg), ("cpu", gc))
             for s in (1, -1)]
    move = {n: max(m[n] for m in moves) for n in gc}
    gap = gaps(gg, gc)
    worst = max(gap, key=gap.get)
    beyond = [f"{n} {gap[n]:.3g} (own move {move[n]:.3g})" for n in gap if gap[n] > 1e-4]
    print(f"  card vs CPU, one BOP batch (2 x 240x320, f32): renders differ by more than 1e-4 at {int((d > 1e-4).sum())} "
          f"of {d.numel()} pixels, by more than 1e-2 at {int((d > 1e-2).sum())} (largest {d.max().item():.3g}); crops "
          f"by {dcrop:.3g} at most; on the card's renders and crops loss {lg:.8g} / {lc:.8g} (relative "
          f"{abs(lg - lc) / abs(lc):.3g}), worst relative gradient gap {gap[worst]:.3g} ({worst}) over {len(gap)} "
          f"tensors; beyond 1e-4: {', '.join(beyond) or 'none'}", flush=True)
    check(int((d > 1e-2).sum()) <= 1e-4 * d.numel() and dcrop <= 1e-4 and abs(lg - lc) <= 1e-4 * abs(lc)
          and all(gap[n] <= max(1e-4, 2 * move[n]) for n in gap), "dataset batch: card and CPU steps differ")

    captured: list = []
    with torch.no_grad():
        for run_name in ("refiner_dr", "coarse_dr"):
            c = run_training.make_config(run_name.split("_")[0], False, run_overrides(run_name) + BOP_TRAIN[:1]
                                         + ["n_dataloader_workers=0"])
            db = run_training.dataset_mesh_db(c, "synthdemo.bop19", str(EVAL_DATA), "cuda")
            ld = run_training.dataset_loader(c, list(db.labels), str(EVAL_DATA), "cuda")
            batch = next(ld).to("cuda")
            ld.close()
            state = tt.create_train_state(c, "cuda")
            d = draws_to(draw_forward_loss(c, c.batch_size, db.points.shape[1], torch.Generator().manual_seed(13)),
                         "cuda")
            restore = record_visibility_inputs(captured)
            try:
                forward_loss(state.model, c, batch, db, d, c.n_iterations)
            finally:
                rt.visibility = restore
    check(len(captured) == 2, f"captured {len(captured)} launches, expected 2")
    kernel_at("train_datasets_refiner_B64", captured[:1], errors, shapes)
    kernel_at("train_datasets_coarse_B128", captured[1:], errors, shapes)


def dataset_eval() -> int:
    """run_eval on 2 synthdemo frames of the coarse and refiner runs that
    phase 19 trained, read from their checkpoints (no seeded weights)."""
    from megapose6d_tpu_torch.inference.load_model import run_checkpoint

    coarse, refiner = DATASET_RUNS / "coarse_bop", DATASET_RUNS / "refiner_bop"
    ckpts = run_checkpoint(coarse), run_checkpoint(refiner)
    check(all(c is not None for c in ckpts), f"no port checkpoints in {coarse} and {refiner}")
    model = build_model(refiner, None, None, device="cuda")
    saved = torch.load(ckpts[1], map_location="cpu", weights_only=True)["params"]
    check(all(torch.equal(p.cpu(), saved[n]) for n, p in model.named_parameters()),
          "build_model did not read the refiner's checkpoint")
    cfg = EvalConfig(ds_name="synthdemo.bop19", data_dir=str(EVAL_DATA), coarse_run=str(coarse),
                     refiner_run=str(refiner), save_dir=str(BUILD_DIR / "dataset_eval"), n_frames=2,
                     inference=InferenceConfig(SO3_grid_size=576, n_pose_hypotheses=4, n_refiner_iterations=3,
                                               max_detections=2),
                     load_depth=True, device="cuda")
    shutil.rmtree(cfg.save_dir, ignore_errors=True)
    before = rt.visibility_kernel.launches
    t0 = time.perf_counter()
    out = run_eval(cfg)
    wall = time.perf_counter() - t0
    n = rt.visibility_kernel.launches - before
    s = out["summary"]
    print(f"  run_eval of the port-trained runs ({', '.join(str(c.relative_to(ROOT)) for c in ckpts)}), 2 frames "
          f"in {wall:.2f} s, K1 launches {n}: {json.dumps(s)}", flush=True)
    check(s["bop"]["n"] > 0 and np.isfinite(s["bop"]["AR"]) and n > 0, "run_eval of the port-trained runs")
    return n


def phase_dataset_training(errors: list[float]) -> tuple[int, dict]:
    """run_training train_datasets= at the committed runs' width: the
    refiner on synthdemo.bop19 with 4 loader workers (20 steps), the
    coarse scorer (5), the refiner on phase 16's webdataset
    shard (480x640 frames cropped and resized to 240x320; 5) with the
    generator's objects written as a models directory; the launches
    counted; a resume with the inline loader, bit for bit an unbroken
    run; each configuration's step by part;
    the loader alone; card against CPU; K1 at the path's shapes; run_eval
    of what was trained."""
    from megapose6d_tpu_torch import native
    from megapose6d_tpu_torch.data.bop_writer import write_bop_models
    from megapose6d_tpu_torch.scripts import generate_synthetic_dataset as gen

    shutil.rmtree(DATASET_RUNS, ignore_errors=True)
    models = DATASET_RUNS / "wds_models"
    write_bop_models(((int(o.label.split("_")[-1]), o.load()) for o in gen._default_objects().objects), models)
    wds = ["train_datasets=webdataset.wds", f"data_dir={BUILD_DIR / 'scene_gen'}", f"object_dataset=dir:{models}"]
    print(f"  image decoder: {native.decoder()}; mesh decimation: "
          f"{'native' if native.meshproc_available() else 'numpy'}; {nvidia_smi()}", flush=True)

    rt.visibility_kernel.launches = 0  # the dataset-fed training path starts here
    t0 = time.perf_counter()
    state_r = run_training.main(dataset_args("refiner_dr", "refiner_bop", 4, "n_epochs=20"))
    t_r = time.perf_counter() - t0
    t0 = time.perf_counter()
    state_c = run_training.main(dataset_args("coarse_dr", "coarse_bop", 4, "n_epochs=5"))
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    state_w = run_training.main(dataset_args("refiner_dr", "refiner_wds", 4, "n_epochs=5") + wds)
    t_w = time.perf_counter() - t0
    launches = rt.visibility_kernel.launches  # read right after the path
    cfg_r, cfg_c = (load_config(DATASET_RUNS / r / "config.json") for r in ("refiner_bop", "coarse_bop"))
    check(cfg_r.backbone_str == "resnet18-spatial" and cfg_r.batch_size == 32 and cfg_r.compute_dtype == "bfloat16"
          and tuple(cfg_r.input_resize) == HW and cfg_r.n_rendered_views == 2 and cfg_r.min_area == 1000
          and cfg_r.n_dataloader_workers == 4 and cfg_c.n_hypotheses == 4, f"not at the committed width: {cfg_r}")
    expected = 20 * cfg_r.n_iterations + 5 + 5 * cfg_r.n_iterations  # no observation render on this path
    print(f"  kernel launches on the dataset-fed training path: {launches} (expected {expected})", flush=True)
    check(launches == expected, "the dataset-fed training path did not launch K1 as expected")
    check(state_r.step == 20 and state_c.step == 5 and state_w.step == 5, "steps")
    for name, run, t in (("refiner bop", "refiner_bop", t_r), ("coarse bop", "coarse_bop", t_c),
                         ("refiner wds", "refiner_wds", t_w)):
        log = read_log(DATASET_RUNS / run)
        check(all(np.isfinite(v) for l in log for v in l.values()) and all("val_loss" not in l for l in log),
              f"{name}: metrics")
        keys = [k for k in log[0] if k.startswith(("loss_total", "grad"))]
        print(f"  {name}: {len(log)} steps in {t:.2f} s (first {log[0]['time_per_epoch']:.2f} s with the workers' "
              f"start, later mean {np.mean([l['time_per_epoch'] for l in log[2:]]):.4f} s); first / last "
              + " ".join(f"{k}={log[0][k]:.4g}/{log[-1][k]:.4g}" for k in keys), flush=True)

    dataset_resume_check()
    # One loader (4 workers, started outside the timed steps) for both
    # configurations' step reports, then alone for its rate; then inline.
    db = run_training.dataset_mesh_db(cfg_r, "synthdemo.bop19", str(EVAL_DATA), "cuda")
    loader = run_training.dataset_loader(cfg_r, list(db.labels), str(EVAL_DATA), "cuda")
    try:
        t0 = time.perf_counter()
        next(loader)
        print(f"  4 workers: first batch after {time.perf_counter() - t0:.2f} s (the workers' start and first batch)",
              flush=True)
        for name, cfg in (("refiner", cfg_r), ("coarse", cfg_c)):
            dataset_step_report(f"{name} (synthdemo.bop19, 4 workers)", tt.create_train_state(cfg, "cuda"), cfg,
                                loader, db)
        rates = {4: loader_rate(loader, 12)}
    finally:
        loader.close()
    inline = run_training.dataset_loader(dataclasses.replace(cfg_r, n_dataloader_workers=0), list(db.labels),
                                         str(EVAL_DATA), "cuda")
    next(inline)
    rates[0] = loader_rate(inline, 3)
    for workers, rate in rates.items():
        print(f"  loader alone, synthdemo.bop19 at 240x320, batch 32, {workers} workers: {rate:.3f} batches/s "
              f"({rate * 32:.1f} samples/s)", flush=True)
    shapes: dict = {}
    dataset_card_vs_cpu(errors, shapes)
    return launches + dataset_eval(), shapes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    pin_f32()
    errors: list[float] = []
    with Phase("device"):
        name = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {name}; {smi}", flush=True)
    with Phase("build"):
        t0 = time.perf_counter()
        rt.visibility_kernel.library()
        print(f"  built in {time.perf_counter() - t0:.2f} s", flush=True)
        for line in rt.visibility_kernel.build_report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
        sass_report()
    with Phase("kernel vs plain"):
        phase_kernel_vs_plain(errors)
    with Phase("pipeline"):
        est, requests, launches, db_kw = phase_pipeline()
    with Phase("cross-check vs cpu"):
        phase_cross_check(requests, db_kw)
    with Phase("kernel timing"):
        timing = phase_kernel_timing(est, requests, errors)
    with Phase("profile"):
        phase_profile(est, requests)
    with Phase("eval rescore"):
        rescore_launches, vsd_shape = phase_eval_rescore(errors)
    with Phase("eval run"):
        run_launches = phase_eval_run()
    with Phase("depth refiners"):
        depth_launches, depth_shapes = phase_depth_refiners(errors)
    with Phase("rgbd"):
        rgbd_launches = phase_rgbd()
    with Phase("depth eval"):
        depth_eval_launches = phase_depth_eval()
    with Phase("training"):
        train_launches, train_shapes = phase_training(errors)
    with Phase("production"):
        prod_launches, prod_shapes = phase_production(errors)
    with Phase("demo finalize"):
        final_launches = phase_demo_finalize()
    with Phase("scene generation"):
        gen_launches, gen_shapes = phase_scene_gen(errors)
    with Phase("detector"):
        det_launches, det_shapes = phase_detector(errors)
    with Phase("detector serving"):
        serve_launches = detector_request() + detector_f32_vs_jax_cpu() + detector_full_eval() + detector_demo()
    with Phase("dataset training"):
        dataset_launches, dataset_shapes = phase_dataset_training(errors)
    timing["by_shape"].update(vsd_shape)
    timing["by_shape"].update(depth_shapes)
    timing["by_shape"].update(train_shapes)
    timing["by_shape"].update(prod_shapes)
    timing["by_shape"].update(gen_shapes)
    timing["by_shape"].update(det_shapes)
    timing["by_shape"].update(dataset_shapes)
    record = {"kernels": [{
        "name": "visibility",
        "route": "cuda",
        "source": "megapose6d_tpu_torch/csrc/visibility.cu",
        "replaces": "megapose6d_tpu/ops/rasterizer_tiled.py:225",
        "launches": launches + rescore_launches + run_launches + depth_launches + rgbd_launches
        + depth_eval_launches + train_launches + prod_launches + final_launches + gen_launches + det_launches
        + serve_launches + dataset_launches,
        "launches_by_path": {"pipeline": launches, "eval_rescore": rescore_launches, "eval_run": run_launches,
                             "depth_refiner": depth_launches, "rgbd": rgbd_launches,
                             "depth_eval": depth_eval_launches, "train": train_launches,
                             "production": prod_launches, "demo_finalize": final_launches,
                             "scene_gen": gen_launches, "detector": det_launches,
                             "detector_serving": serve_launches, "train_datasets": dataset_launches},
        "max_abs_err": max(errors),
        **timing,
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
