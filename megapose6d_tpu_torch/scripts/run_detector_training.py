"""Detector training on scenes rendered on the device.

Counterpart of `megapose6d_tpu/scripts/run_detector_training.py`: the
CenterNet detector (`models/detector.py`) trains on batches of the scene
generator (`scripts/generate_synthetic_dataset.py`), all scenes of a batch
in one render per pass, with Adam under optax's warm-up + cosine schedule
in optax's arithmetic (`training/train.py`'s `Adam`). The run directory
keeps the JAX layout: `labels.json`, `config.json`, `log.txt`,
`checkpoints/step_<N>/state.pt` (params and Adam's state, `torch.save` in
place of orbax), `checkpoints/latest.txt` and `checkpoints/final/state.pt`
(params only). Running the same command again resumes from `latest.txt`.

Batch `i` is keyed as in an unbroken JAX run, the i-th `key, sub =
split(key)` from `fold_in(PRNGKey(seed), 0)`, also after a resume (the JAX
script re-keys a resumed segment with `fold_in(PRNGKey(seed), start)`), so
a resumed run is the unbroken one.

    python -m megapose6d_tpu_torch.scripts.run_detector_training run_id=det n_steps=2000 \\
        batch_size=16 demo_world=1 predict_masks=1 [run_dir=build/runs] [device=cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..meshes.io import make_cube, make_uv_sphere
from ..meshes.mesh_db import BatchedMeshes, MeshDataBase, RigidObject, RigidObjectDataset
from ..meshes.worlds import bop_world_objects
from ..models.detector import CenterNetDetector, DetectorConfig, decode_detections, detection_loss, segmentation_loss
from ..ops._precision import pin_f32
from ..training.train import Adam
from ..utils import threefry
from .generate_synthetic_dataset import SceneRenderer

logger = logging.getLogger(__name__)
Tensor = torch.Tensor


class DetectorBatches:
    """`key -> (rgbs [B, H, W, 3], boxes [B, n, 4], classes [B, n], valid
    [B, n])` and, `with_seg`, the class maps `[B, H, W]` (-1 background):
    `split(key, batch_size)` scenes of `n_obj` objects, the boxes the
    extents of each object's visible pixels, valid where it has any."""

    def __init__(self, mesh_db: BatchedMeshes, batch_size: int, resolution, n_obj: int, f: float = 400.0,
                 with_seg: bool = False):
        self.render = SceneRenderer(mesh_db, n_obj, resolution, f)
        self.batch_size, self.n_obj, self.with_seg = batch_size, n_obj, with_seg

    def __call__(self, key: np.ndarray) -> tuple[Tensor, ...]:
        out = self.render(threefry.split(key, self.batch_size))
        seg, mesh_idx = out["seg"], out["mesh_idx"]
        B, H, W = seg.shape
        dev = seg.device
        m = seg[:, None] == torch.arange(1, self.n_obj + 1, device=dev, dtype=seg.dtype)[None, :, None, None]
        rows, cols = m.any(3), m.any(2)  # [B, n, H], [B, n, W]
        ys, xs = torch.arange(H, device=dev), torch.arange(W, device=dev)
        y1 = torch.where(rows, ys, H).amin(-1)
        x1 = torch.where(cols, xs, W).amin(-1)
        y2 = torch.where(rows, ys, -1).amax(-1) + 1
        x2 = torch.where(cols, xs, -1).amax(-1) + 1
        boxes = torch.stack([x1, y1, x2, y2], -1).float()
        batch = (out["rgb"], boxes, mesh_idx.to(torch.int32), rows.any(-1))
        if self.with_seg:
            cls = mesh_idx.gather(1, (seg.long() - 1).clamp_min(0).reshape(B, -1)).reshape(B, H, W)
            batch = batch + (torch.where(seg > 0, cls, -1).to(torch.int32),)
        return batch


def make_batch_fn(mesh_db: BatchedMeshes, batch_size: int, resolution, n_obj: int, f: float = 400.0,
                  with_seg: bool = False) -> DetectorBatches:
    """The detector's batches under the JAX package's name: `key -> batch`
    (`DetectorBatches`)."""
    return DetectorBatches(mesh_db, batch_size, resolution, n_obj, f, with_seg)


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int, decay_steps: int, end_value: float):
    """optax's `warmup_cosine_decay_schedule(init_value=0, ...)` in its
    float32 arithmetic: `count -> lr` (a float32 value). The cosine is
    float64's rounded to float32; XLA's float32 cosine differs from it in
    the last bit at ~0.5% of the counts of a 12000-step schedule."""
    f32 = np.float32
    alpha = f32(end_value / peak_value) if peak_value else f32(0)
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(f32(0) - f32(peak_value)) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        decay = f32(0.5) * (f32(1) + f32(np.cos(np.float64(f32(np.pi) * c / f32(cos_steps)))))
        return float(f32(peak_value) * ((f32(1) - alpha) * decay + alpha))

    return schedule


def batch_key(seed: int, step: int) -> np.ndarray:
    """The key the batch of `step` is split from: `step` splits of
    `fold_in(PRNGKey(seed), 0)`."""
    key = threefry.fold_in(threefry.PRNGKey(seed), 0)
    for _ in range(step):
        key = threefry.split(key)[0]
    return key


def losses(model: CenterNetDetector, batch: tuple[Tensor, ...]) -> tuple[Tensor, dict[str, Tensor]]:
    rgbs, boxes, classes, valid = batch[:4]
    out = model(rgbs)
    loss, aux = detection_loss(out, boxes, classes, valid, model.cfg.stride)
    if len(batch) > 4:
        seg_l = segmentation_loss(out, batch[4], model.cfg.stride)
        loss = loss + seg_l
        aux = dict(aux, det_seg_loss=seg_l)
    return loss, aux


def train_step(model: CenterNetDetector, optimizer: Adam, opt_state: dict, batch) -> tuple[Tensor, dict]:
    """One Adam update of `model` on `batch`; (loss, its parts)."""
    params = list(model.parameters())
    loss, aux = losses(model, batch)
    grads = torch.autograd.grad(loss, params)
    optimizer.update(params, list(grads), opt_state)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def save_state(path: Path, model: CenterNetDetector, opt_state: dict | None, step: int) -> None:
    path.mkdir(parents=True, exist_ok=True)
    names = [n for n, _ in model.named_parameters()]
    cpu = lambda ts: {n: t.detach().cpu() for n, t in zip(names, ts)}
    state = {"params": cpu(list(model.parameters())), "step": step}
    if opt_state is not None:
        state["opt_state"] = {"count": opt_state["count"], "mu": cpu(opt_state["mu"]), "nu": cpu(opt_state["nu"])}
    torch.save(state, path / "state.pt")


@torch.no_grad()
def load_state(path: Path, model: CenterNetDetector, opt_state: dict | None) -> int:
    saved = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(saved["params"])
    if opt_state is not None and "opt_state" in saved:  # a slimmed checkpoint resumes with a fresh Adam
        names = [n for n, _ in model.named_parameters()]
        for key in ("mu", "nu"):
            for t, n in zip(opt_state[key], names):
                t.copy_(saved["opt_state"][key][n])
        opt_state["count"] = int(saved["opt_state"]["count"])
    return int(saved["step"])


def training_objects(args: dict[str, str]) -> RigidObjectDataset:
    if args["demo_world"] == "1":  # the demo world of the pose demos and demo_ar_baseline
        return bop_world_objects("demo")
    if args["object_dataset"]:
        from ..data.datasets_cfg import make_object_dataset

        return make_object_dataset(args["object_dataset"], data_dir=args["data_dir"] or None)
    return RigidObjectDataset([RigidObject(label="cube", mesh=make_cube(0.04)),
                               RigidObject(label="sphere", mesh=make_uv_sphere(0.04))])


DEFAULTS = dict(
    run_id="detector", run_dir="runs", n_steps="1000", batch_size="8", resolution="240,320",
    n_obj_per_scene="2", lr="1e-3", width="32", object_dataset="", data_dir="", log_every="50", seed="0",
    predict_masks="0", demo_world="0", n_eval="0", max_seconds="1e9", ckpt_every="1000", device="cuda",
)


@dataclasses.dataclass
class DetectorRun:
    """What `main` returns: the model, Adam's state, the completed steps
    and, with `n_eval`, the evaluation report."""

    model: CenterNetDetector
    opt_state: dict
    step: int
    report: dict | None = None


def main(argv=None) -> DetectorRun:
    args = dict(DEFAULTS)
    for a in sys.argv[1:] if argv is None else argv:
        k, _, v = a.partition("=")
        if k not in args:
            raise ValueError(f"unknown arg {k}")
        args[k] = v
    pin_f32()
    device = torch.device(args["device"])
    mesh_db = MeshDataBase.from_object_ds(training_objects(args)).batched(device=device)
    resolution = tuple(int(x) for x in args["resolution"].split(","))
    predict_masks = bool(int(args["predict_masks"]))
    cfg = DetectorConfig(n_classes=len(mesh_db.labels), width=int(args["width"]), predict_masks=predict_masks)
    model = CenterNetDetector(cfg).init_weights(torch.Generator().manual_seed(0)).to(device).train()
    n_steps, lr, seed = int(args["n_steps"]), float(args["lr"]), int(args["seed"])
    optimizer = Adam(warmup_cosine_decay_schedule(lr, min(500, max(1, n_steps // 10)), max(n_steps, 2), lr * 0.01))
    opt_state = Adam.init(list(model.parameters()))
    batch_fn = DetectorBatches(mesh_db, int(args["batch_size"]), resolution, int(args["n_obj_per_scene"]),
                             with_seg=predict_masks)

    run_dir = Path(args["run_dir"]) / args["run_id"]
    ckpt_dir = run_dir / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "labels.json").write_text(json.dumps(list(mesh_db.labels)))
    (run_dir / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
    latest = ckpt_dir / "latest.txt"
    start = 0
    if latest.exists():
        start = load_state(ckpt_dir / f"step_{int(latest.read_text())}", model, opt_state)
        logger.info("resumed from step %d", start)

    def save(step: int) -> None:
        save_state(ckpt_dir / f"step_{step}", model, opt_state, step)
        latest.write_text(str(step))

    key = batch_key(seed, start)
    t0 = time.monotonic()
    done = start  # completed steps: the time check follows each step
    for i in range(start, n_steps):
        key, sub = threefry.split(key)
        loss, aux = train_step(model, optimizer, opt_state, batch_fn(sub))
        done = i + 1
        if done % int(args["log_every"]) == 0:
            log = {"step": done, "loss": float(loss), **{k: float(v) for k, v in aux.items()},
                   "time": time.monotonic() - t0}
            logger.info("%s", log)
            with open(run_dir / "log.txt", "a") as fh:
                fh.write(json.dumps(log) + "\n")
        if done % int(args["ckpt_every"]) == 0:
            save(done)
        if time.monotonic() - t0 > float(args["max_seconds"]):
            break
    if done > start and (not latest.exists() or int(latest.read_text()) != done):
        save(done)
    save_state(ckpt_dir / "final", model, None, done)
    logger.info("saved detector to %s", run_dir)

    run = DetectorRun(model.eval(), opt_state, done)
    if int(args["n_eval"]):
        run.report = evaluate_detector(model, model.cfg, batch_fn, int(args["n_eval"]), predict_masks, seed=seed + 777)
        (run_dir / "eval.json").write_text(json.dumps(run.report, indent=2))
        logger.info("detector eval: %s", json.dumps(run.report))
    return run


@torch.no_grad()
def evaluate_detector(model: CenterNetDetector, cfg: DetectorConfig | None, batch_fn: DetectorBatches, n_batches: int,
                      predict_masks: bool, seed: int = 777) -> dict:
    """Held-out metrics over `n_batches` batches keyed from `PRNGKey(seed)`:
    recall at IoU 0.5 of the detections above 0.3 among the top 8, the mean
    IoU and class accuracy of each ground-truth box's best match, and with
    masks the mean IoU of the class's segmentation (logit > 0) with the
    ground truth at the head's stride."""
    model.eval()
    s = (cfg or model.cfg).stride
    ious, cls_ok, found, mask_ious = [], [], [], []
    key = threefry.PRNGKey(seed)
    for _ in range(n_batches):
        key, sub = threefry.split(key)
        batch = batch_fn(sub)
        gt_boxes, gt_classes, gt_valid = (x.cpu().numpy() for x in batch[1:4])
        seg = batch[4].cpu().numpy() if predict_masks else None
        out = model(batch[0])
        dec = {k: v.cpu().numpy() for k, v in decode_detections(out, s, top_k=8).items()}
        seg_pred = out["seg"].cpu().numpy() if predict_masks else None
        for b in range(gt_boxes.shape[0]):
            keep = np.nonzero(dec["scores"][b] > 0.3)[0]
            for g in range(gt_boxes.shape[1]):
                if not gt_valid[b, g]:
                    continue
                gx1, gy1, gx2, gy2 = gt_boxes[b, g]
                best_iou, best_j = 0.0, -1
                for j in keep:
                    x1, y1, x2, y2 = dec["boxes"][b, j]
                    inter = max(0.0, min(x2, gx2) - max(x1, gx1)) * max(0.0, min(y2, gy2) - max(y1, gy1))
                    union = (x2 - x1) * (y2 - y1) + (gx2 - gx1) * (gy2 - gy1) - inter
                    iou = inter / union if union > 0 else 0.0
                    if iou > best_iou:
                        best_iou, best_j = iou, j
                found.append(float(best_iou > 0.5))
                if best_j < 0:
                    continue
                ious.append(best_iou)
                cls_ok.append(float(dec["classes"][b, best_j] == gt_classes[b, g]))
                if seg_pred is not None:
                    c = int(gt_classes[b, g])
                    pm, gm = seg_pred[b, :, :, c] > 0, seg[b][::s, ::s] == c
                    mh, mw = min(pm.shape[0], gm.shape[0]), min(pm.shape[1], gm.shape[1])
                    pm, gm = pm[:mh, :mw], gm[:mh, :mw]
                    u = (pm | gm).sum()
                    if u:
                        mask_ious.append(float((pm & gm).sum() / u))
    rep = {
        "n_gt": len(found),
        "recall@iou0.5": float(np.mean(found)) if found else 0.0,
        "mean_iou_matched": float(np.mean(ious)) if ious else 0.0,
        "class_accuracy": float(np.mean(cls_ok)) if cls_ok else 0.0,
    }
    if mask_ious:
        rep["mean_mask_iou"] = float(np.mean(mask_ious))
    return rep


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
