"""K1 (`megapose6d_tpu_torch/csrc/visibility.cu`) at the main path's launch
shapes, for comparing two trees of the port in one call on one card.

    python3 bench_k1.py capture build/k1_launches.pt
    K1_TREE=<root of a checkout> python3 bench_k1.py time build/k1_launches.pt <out.json>

`capture` runs pieces of the main path with this tree, through
chip_smoke.py's helpers (seeded weights): one request of phase 4's RGB
pipeline (coarse B=576, refiner B=20, rescore B=10, 240x320, 1536 faces),
the ICP depth refiner on the ar_gnc frames with two objects (B=2,
120x160), the VSD renders of the committed evaluation (B=2, 240x320; the
launches of the longest, the median and the shortest chains), a detector
training batch (main and shadow passes, B=32), a demo datagen scene (B=2)
and the observations of a synthetic training batch (B=32), and saves their
phase-B inputs.

`time` loads them and times the kernel of the tree at K1_TREE (this tree
when unset), each launch held bit for bit against that tree's plain twin:
the CUDA-event ms of 20 launches back to back, the device's ms a launch
with the host ahead of it, the host's ms to issue one; for a tree whose
kernel splits long chains, also at split 1 and across chip_smoke's SWEEP.
Run parent, change, change, parent in one call and compare within it.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

if os.environ.get("K1_TREE"):
    sys.path.insert(0, os.path.abspath(os.environ["K1_TREE"]))

import torch  # noqa: E402


def this_chip_smoke():
    """This tree's chip_smoke.py (a tree at K1_TREE has one of its own),
    importing the port of the tree on the path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).with_name("chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def capture(path: str) -> None:
    import shutil

    cs = this_chip_smoke()
    from megapose6d_tpu_torch.evaluation.eval_config import EvalConfig, get_save_dir
    from megapose6d_tpu_torch.evaluation.evaluation import run_eval
    from megapose6d_tpu_torch.inference.depth_refiner import ICPRefiner
    from megapose6d_tpu_torch.scripts import generate_synthetic_dataset as gen
    from megapose6d_tpu_torch.scripts import run_detector_training as rdt

    cs.pin_f32()
    groups: dict[str, list] = {}
    cfg_c, db_kw = cs.config_from_run_json(cs.ROOT / "runs/coarse_dr/config.json")
    cfg_r, _ = cs.config_from_run_json(cs.ROOT / "runs/refiner_dr/config.json")
    icfg = cs.InferenceConfig()
    est = cs.build_scene_pipeline(cfg_c, cfg_r, db_kw, icfg, "cuda")
    requests = cs.scene_requests(2)
    est.run_inference_pipeline(*requests[0])
    with torch.inference_mode():
        launches = cs.capture_launches(est, *requests[1])
    for phase, vis in zip(cs.launch_phases(len(requests[1][1]), icfg), launches):
        groups.setdefault(f"{phase}_B{vis[0].shape[0]}", []).append(vis)
    groups["coarse_B576"] = groups["coarse_B576"][:1]

    db = cs.demo_ar_baseline.world_mesh_db(cs.AR_GNC / "synthdemo", "cuda")
    icp = ICPRefiner(db)
    captured: list = []
    restore = cs.record_visibility_inputs(captured)
    try:
        for frame, labels, poses in cs.ar_gnc_frames():
            if len(labels) == 2:
                cs.refine_frame(icp, frame, labels, poses, "cuda")
    finally:
        cs.rt.visibility = restore
    groups["depth_refiner_B2"] = captured

    save_root = cs.BUILD_DIR / "k1_vsd"
    shutil.rmtree(save_root, ignore_errors=True)
    cfg = EvalConfig(ds_name="synthdemo.bop19", data_dir=str(cs.EVAL_DATA), save_dir=str(save_root),
                     skip_inference=True, load_depth=True, device="cuda")
    get_save_dir(cfg).mkdir(parents=True)
    for f in ("results.npz", "results.json"):
        shutil.copy(cs.COMMITTED_EVAL / f, get_save_dir(cfg) / f)
    captured = []
    restore = cs.record_visibility_inputs(captured)
    try:
        run_eval(cfg)
    finally:
        cs.rt.visibility = restore
    vsd = sorted((v for v in captured if v[0].shape[0] == 2), key=lambda v: int(v[2].max()))
    groups["vsd_B2"] = [vsd[-1], vsd[len(vsd) // 2], vsd[0]]

    mesh_db = cs.MeshDataBase.from_object_ds(cs.worlds.bop_world_objects("demo")).batched(device="cuda")
    det = cs.render_launches(rdt.DetectorBatches(mesh_db, 16, cs.HW, 2, with_seg=True).render,
                             cs.threefry.split(cs.threefry.PRNGKey(9), 16))
    groups["detector_train_main_B32"], groups["detector_train_shadow_B32"] = det[:1], det[1:]
    demo_db, _ = cs.worlds.build_bop_world("demo", "cuda")
    gen_l = cs.render_launches(gen.SceneRenderer(demo_db, 2, cs.HW, 400.0),
                               cs.threefry.split(cs.threefry.PRNGKey(123))[1])
    groups["datagen_main_B2"], groups["datagen_shadow_B2"] = gen_l[:1], gen_l[1:]
    _, _, synth = cs.train_setup("refiner_dr")
    captured = []
    restore = cs.record_visibility_inputs(captured)
    try:
        with torch.no_grad():
            synth(torch.Generator().manual_seed(1))
    finally:
        cs.rt.visibility = restore
    groups["train_obs_B32"] = captured
    torch.save({k: [tuple(x.cpu() if torch.is_tensor(x) else x for x in v) for v in vs]
                for k, vs in groups.items()}, path)
    print(json.dumps({k: [tuple(v[0].shape) + (int(v[2].max()),) for v in vs] for k, vs in groups.items()}),
          flush=True)


def time_tree(path: str, out: str) -> None:
    from megapose6d_tpu_torch.ops import rasterizer_tiled as rt

    cs = this_chip_smoke()

    # Trees before the 16-face chunk became a constant take it as an argument.
    old = "chunk" in inspect.signature(rt.visibility_plain).parameters
    args = (lambda vis: vis + (16,)) if old else (lambda vis: vis)
    splits = not old and hasattr(rt, "split_for")
    groups = torch.load(path)
    rt.visibility_kernel.library()
    res: dict = {}
    for key, launches in groups.items():
        res[key] = []
        for vis in launches:
            vis = tuple(x.cuda() if torch.is_tensor(x) else x for x in vis)
            kern = lambda s=None, v=args(vis): rt.visibility_kernel(*v, **({"split": s} if s else {}))  # noqa: E731
            plain = rt.visibility_plain(*args(vis))
            cs.compare_visibility(kern(), plain)
            r = dict(longest=int(vis[2].max()), ms=cs.cuda_ms(kern, reps=20, warmup=3),
                     device_ms=cs.queued_ms(kern, 20), host_ms=cs.host_ms(kern, 20))
            if splits:
                r["split"] = rt.split_for(vis[0].shape[0] * vis[1].shape[1], vis[1].shape[2])
                r["sweep_device_ms"] = {}
                for s in cs.SWEEP:
                    cs.compare_visibility(kern(s), plain)
                    r["sweep_device_ms"][s] = cs.queued_ms(lambda: kern(s), 20)
                r["s1_ms"] = cs.cuda_ms(lambda: kern(1), reps=20, warmup=3)
            res[key].append(r)
        print(f"{key}: " + "; ".join(json.dumps(r) for r in res[key]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps({"tree": os.environ.get("K1_TREE", "."), "device": smi,
                                     "torch": torch.__version__, "groups": res}, indent=1))
    print(f"{smi}; wrote {out}", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("bench_k1: CUDA is not available")
    if sys.argv[1:2] == ["capture"] and len(sys.argv) == 3:
        capture(sys.argv[2])
    elif sys.argv[1:2] == ["time"] and len(sys.argv) == 4:
        time_tree(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
