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
     240x320, weights from a seed) on 3 requests of the committed scene,
     with the kernel's launches counted;
  5. cross-check: the pipeline's phases at a small size on the GPU against
     the same models on the CPU (plain phase B), in f32;
  6. kernel timing at the shapes of every render of one request (coarse
     sweep, refiner, rescore), each launch held bit for bit against the
     plain twin; per phase the kernel's and the plain twin's times and the
     bound, and the kernel's sum per request; at the coarse shape also the
     store floor (the same tables with no active chunk) and the share of
     face evaluations the kernel's cull leaves;
  7. profile: one more request under torch.profiler: the device's busy
     share of the request's wall time and the kernels with the most device
     time.
The line before the last is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`. Any failure raises and exits nonzero.
"""

from __future__ import annotations

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

from megapose6d_tpu_torch.data.types import ObservationTensor
from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
from megapose6d_tpu_torch.inference.types import InferenceConfig, make_detections
from megapose6d_tpu_torch.interop.from_jax import config_from_run_json
from megapose6d_tpu_torch.meshes import io as mesh_io
from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase, RigidObject, RigidObjectDataset
from megapose6d_tpu_torch.models.pose_predictor import PosePredictorConfig, build_pose_predictor
from megapose6d_tpu_torch.ops import rasterizer_tiled as rt
from megapose6d_tpu_torch.ops._nvcc import BUILD_DIR
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.ops.camera import masked_boxes_from_uv, project_points_robust

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "runs/ar_baseline/synthdemo"
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


def scene_requests(est: PoseEstimator, n: int):
    """Observations rendered by the port at the scene's ground-truth poses
    (nearest surface wins across objects), with the projected ground-truth
    boxes as detections."""
    gt = json.loads((SCENE / "test/000000/scene_gt.json").read_text())
    K = torch.as_tensor(scene_K(), device="cuda")
    db = est.mesh_db
    requests = []
    for im_id in sorted(gt, key=int)[:n]:
        labels = [f"obj_{o['obj_id']:06d}" for o in gt[im_id]]
        TCO = np.tile(np.eye(4, dtype=np.float32), (len(labels), 1, 1))
        for i, o in enumerate(gt[im_id]):
            TCO[i, :3, :3] = np.asarray(o["cam_R_m2c"], np.float32).reshape(3, 3)
            TCO[i, :3, 3] = np.asarray(o["cam_t_m2c"], np.float32) / 1000.0
        TCO = torch.as_tensor(TCO, device="cuda")
        m = db.select(db.label_to_index(labels))
        Ks = K.expand(len(labels), 3, 3)
        r = rt.render_meshes_tiled(m.vertices, m.normals, m.colors, m.faces, m.face_valid, TCO, Ks,
                                   HW, backface_cull=True)
        depth = torch.where(r.mask, r.depth, torch.full_like(r.depth, float("inf")))
        nearest = depth.argmin(dim=0)
        rgb = torch.gather(r.rgb, 0, nearest[None, ..., None].expand(1, *HW, 3))[0]
        uv = project_points_robust(m.points, Ks, TCO)
        boxes = masked_boxes_from_uv(uv, torch.ones(uv.shape[:2], dtype=torch.bool, device="cuda"))
        obs = ObservationTensor(rgb[None].contiguous(), K[None].clone())
        requests.append((obs, make_detections(labels, boxes.cpu().numpy(), device=boxes.device), TCO))
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
    requests = scene_requests(est, 3)

    rt.visibility_kernel.launches = 0  # the main path starts here
    expected = 0
    for i, (obs, dets, _) in enumerate(requests):
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
    obs, dets, _ = requests[0]
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
    Ra, Rb = out["cuda"][1][:, :3, :3], out["cpu"][1][:, :3, :3]
    cos = ((Ra.transpose(1, 2) @ Rb).diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2
    deg = torch.rad2deg(torch.arccos(cos.clamp(-1, 1))).max().item()
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


def capture_launches(est, obs, dets) -> list[tuple]:
    """The phase-B inputs of every render of one more request, in launch
    order (the kernel launches as on the main path)."""
    captured = []
    visibility = rt.visibility

    def record(coefs, ids, n_act, hw, chunk):
        captured.append((coefs.clone(), ids.clone(), n_act.clone(), tuple(hw), chunk))
        return visibility(coefs, ids, n_act, hw, chunk)

    rt.visibility = record
    try:
        est.run_inference_pipeline(obs, dets)
    finally:
        rt.visibility = visibility
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
    obs, dets, _ = requests[-1]
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

    obs, dets, _ = requests[1]
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
    record = {"kernels": [{
        "name": "visibility",
        "route": "cuda",
        "source": "megapose6d_tpu_torch/csrc/visibility.cu",
        "replaces": "megapose6d_tpu/ops/rasterizer_tiled.py:225",
        "launches": launches,
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
