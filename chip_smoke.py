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
     the trained weights when build/weights/coarse_dr.npz and
     refiner_dr.npz exist (written by `python -m tests.test_torch_checkpoints
     export ...` where the JAX package is installed); with the trained
     weights also the same frames with the models in f32, and each of the
     two runs against the other and against the committed JAX predictions,
     per instance.
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
from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
from megapose6d_tpu_torch.inference.types import InferenceConfig, make_detections
from megapose6d_tpu_torch.interop.from_jax import config_from_run_json
from megapose6d_tpu_torch.meshes import io as mesh_io
from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase, RigidObject, RigidObjectDataset
from megapose6d_tpu_torch.models.pose_predictor import PosePredictorConfig, build_pose_predictor
from megapose6d_tpu_torch.ops import rasterizer_tiled as rt
from megapose6d_tpu_torch.ops._nvcc import BUILD_DIR
from megapose6d_tpu_torch.ops._precision import pin_f32

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "runs/ar_baseline/synthdemo"
EVAL_DATA = ROOT / "runs/ar_dr"  # holds synthdemo/, the BOP test set of the committed evaluation
COMMITTED_EVAL = ROOT / "runs/full_eval/synthdemo.bop19/gt+SO3_grid"
WEIGHTS = ROOT / "build/weights"
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
    """Angles in degrees between the rotations of poses `[..., 4, 4]`."""
    cos = ((a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]).diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    return torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))


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
    # SO3_prune_keep and depth_refiner are read only by modes not ported yet.
    icfg = InferenceConfig(**{k: v for k, v in ecfg["inference"].items()
                              if k not in ("SO3_prune_keep", "depth_refiner")})
    trained = all((WEIGHTS / f"{run}.npz").exists() for run in ("coarse_dr", "refiner_dr"))
    print(f"  weights: {'trained, ' + str(WEIGHTS) if trained else 'seeded (no npz files in build/weights)'}; "
          f"frames: {'all' if trained else 8}; inference {icfg}", flush=True)
    save_root = BUILD_DIR / "eval_run"
    shutil.rmtree(save_root, ignore_errors=True)
    weights = lambda run: str(WEIGHTS / f"{run}.npz") if trained else ""
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
        print(f"  trained AR on the card: {summary['bop']['AR']:.6f} (committed JAX evaluation 0.2453)", flush=True)
    expected = sum(len(launch_phases(d, icfg)) for d in dets) + 2 * len(frames)
    print(f"  kernel launches: {launches} (expected {expected}: the pipeline's and 2 VSD renders per frame)",
          flush=True)
    check(csv_rows == len(final) == summary["bop"]["n"] > 0, "CSV rows, predictions and summary disagree")
    check(launches == expected, "the eval run did not launch the kernel as expected")
    if trained:
        trained_vs_committed(cfg, out["results_path"])
    return launches


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
    timing["by_shape"].update(vsd_shape)
    record = {"kernels": [{
        "name": "visibility",
        "route": "cuda",
        "source": "megapose6d_tpu_torch/csrc/visibility.cu",
        "replaces": "megapose6d_tpu/ops/rasterizer_tiled.py:225",
        "launches": launches + rescore_launches + run_launches,
        "launches_by_path": {"pipeline": launches, "eval_rescore": rescore_launches, "eval_run": run_launches},
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
