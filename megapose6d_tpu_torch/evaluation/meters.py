"""Evaluation meters: pose errors accumulated per view.

Counterpart of `megapose6d_tpu/evaluation/meters.py`, without pandas: the
matching works on the collections' numpy info columns, the error kernels
are batched torch on the mesh database's device.

`BOPScoreMeter`: BOP19 average recall from MSSD, MSPD and, given the
frame's depth, VSD. `ModelNetErrorMeter`: ADD < 0.1 diameter, 5 deg /
5 cm, proj2d < 5 px. A ground-truth instance without a prediction, and a
non-finite error, count as infinite error: a miss.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..data.tensor_collection import TensorCollection
from ..ops import se3
from ..ops.camera import project_points
from .vsd import BOP19_VSD_TAUS, compute_vsd, vsd_recall

Tensor = torch.Tensor


def _key_rows(infos: dict[str, np.ndarray], keys) -> list[tuple]:
    return list(zip(*(infos[k].tolist() for k in keys)))


def one_to_one_matching(pred_infos, gt_infos, keys=("scene_id", "view_id", "label"),
                        allow_pred_missing: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Match prediction rows to ground-truth rows on equal key columns.

    Returns (pred_ids, gt_ids) in ground-truth order. Raises ValueError when
    the keys repeat on either side (a multi-instance scene without
    `instance_id` in the keys), and unless `allow_pred_missing`, when a
    ground-truth row has no prediction."""
    pred_rows, gt_rows = _key_rows(pred_infos, keys), _key_rows(gt_infos, keys)
    for name, rows in (("pred", pred_rows), ("gt", gt_rows)):
        if len(set(rows)) != len(rows):
            raise ValueError(f"one_to_one_matching: duplicate {list(keys)} keys in {name} infos "
                             "(multi-instance scene?); include 'instance_id' in keys")
    where = {r: i for i, r in enumerate(pred_rows)}
    pred_ids, gt_ids = [], []
    for g, r in enumerate(gt_rows):
        if r in where:
            pred_ids.append(where[r])
            gt_ids.append(g)
        elif not allow_pred_missing:
            raise ValueError("missing predictions")
    return np.asarray(pred_ids, int), np.asarray(gt_ids, int)


def match_predictions(pred_infos, gt_infos) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Prediction rows matched to ground-truth rows.

    Exact key matching on (scene_id, view_id, label, instance_id), those
    present on both sides, when it holds; otherwise BOP19 greedy matching
    per (scene_id, view_id, label): predictions claim ground-truth
    instances in descending score order, and the unclaimed instances are
    returned as misses. Returns (pred_ids, gt_ids, missed_gt_ids)."""
    keys = tuple(k for k in ("scene_id", "view_id", "label", "instance_id")
                 if k in pred_infos and k in gt_infos)
    try:
        pred_ids, gt_ids = one_to_one_matching(pred_infos, gt_infos, keys=keys)
        return pred_ids, gt_ids, np.zeros((0,), int)
    except ValueError:
        pass
    group_keys = tuple(k for k in ("scene_id", "view_id", "label") if k in pred_infos and k in gt_infos)
    score_col = next((c for c in ("score", "pose_score", "pose_logit") if c in pred_infos), None)
    pred_groups: dict[tuple, list[int]] = defaultdict(list)
    for i, r in enumerate(_key_rows(pred_infos, group_keys)):
        pred_groups[r].append(i)
    gt_groups: dict[tuple, list[int]] = defaultdict(list)  # in order of first appearance
    for i, r in enumerate(_key_rows(gt_infos, group_keys)):
        gt_groups[r].append(i)
    pred_ids, gt_ids, missed = [], [], []
    for key, gts in gt_groups.items():
        preds = pred_groups.get(key, [])
        if score_col is not None:
            scores = np.asarray(pred_infos[score_col], np.float64)[preds]
            preds = [preds[i] for i in np.argsort(-scores, kind="stable")]
        for i, g in enumerate(gts):
            if i < len(preds):
                pred_ids.append(preds[i])
                gt_ids.append(g)
            else:
                missed.append(g)
    return np.asarray(pred_ids, int), np.asarray(gt_ids, int), np.asarray(missed, int)


def compute_errors(TCO_pred: Tensor, TCO_gt: Tensor, points: Tensor, K: Tensor,
                   symmetric: Tensor | None = None) -> dict[str, np.ndarray]:
    """Batched pose errors: ADD, ADD-S, rotation (degrees), translation and
    2D projection errors, `[N]` each. `TCO_* [N, 4, 4]`, `points [N, P, 3]`,
    `K [N, 3, 3]`."""
    pred_pts = se3.transform_pts(TCO_pred, points)
    gt_pts = se3.transform_pts(TCO_gt, points)
    add = torch.linalg.norm(pred_pts - gt_pts, dim=-1).mean(-1)
    d2 = ((pred_pts[:, :, None, :] - gt_pts[:, None, :, :]) ** 2).sum(-1)
    adds = torch.sqrt(d2.amin(dim=-1)).mean(-1)
    rot_err_deg = torch.rad2deg(se3.geodesic_distance(TCO_pred[:, :3, :3], TCO_gt[:, :3, :3]))
    trans_err = torch.linalg.norm(TCO_pred[:, :3, 3] - TCO_gt[:, :3, 3], dim=-1)
    proj2d = torch.linalg.norm(project_points(points, K, TCO_pred) - project_points(points, K, TCO_gt),
                               dim=-1).mean(-1)
    add_or_adds = add if symmetric is None else torch.where(symmetric, adds, add)
    out = dict(add=add, adds=adds, add_or_adds=add_or_adds, rot_err_deg=rot_err_deg,
               trans_err=trans_err, proj2d=proj2d)
    return {k: v.cpu().numpy() for k, v in out.items()}


def compute_mssd_mspd(TCO_pred: Tensor, TCO_gt: Tensor, points: Tensor, K: Tensor,
                      symmetries: Tensor, sym_valid: Tensor | None = None) -> dict[str, np.ndarray]:
    """Maximum Symmetry-aware Surface and Projection Distances `[N]`:

      MSSD = min_S max_p | T_pred p - T_gt S p |
      MSPD = min_S max_p | proj(T_pred p) - proj(T_gt S p) |

    `symmetries [N, S, 4, 4]` identity-padded, `sym_valid [N, S]`."""
    TCO_gt_sym = torch.einsum("nij,nsjk->nsik", TCO_gt, symmetries)  # [N, S, 4, 4]
    pred_pts = se3.transform_pts(TCO_pred, points)  # [N, P, 3]
    gt_pts = se3.transform_pts(TCO_gt_sym, points)  # [N, S, P, 3]
    max_3d = torch.linalg.norm(pred_pts[:, None] - gt_pts, dim=-1).amax(-1)  # [N, S]
    uv_pred = project_points(points, K, TCO_pred)  # [N, P, 2]
    uv_gt = project_points(points[:, None], K[:, None], TCO_gt_sym)  # [N, S, P, 2]
    max_2d = torch.linalg.norm(uv_pred[:, None] - uv_gt, dim=-1).amax(-1)  # [N, S]
    if sym_valid is not None:
        max_3d = torch.where(sym_valid, max_3d, 1e30)
        max_2d = torch.where(sym_valid, max_2d, 1e30)
    return {"mssd": max_3d.amin(-1).cpu().numpy(), "mspd": max_2d.amin(-1).cpu().numpy()}


def _finite_or_inf(x: np.ndarray) -> list[float]:
    """A non-finite error (a NaN pose) is a miss: inf keeps the recall
    thresholds false and the medians meaningful."""
    return np.where(np.isfinite(x), x, np.inf).tolist()


class Meter:
    """Accumulates per-frame rows in `datas` (`add`), which `summary`
    reduces."""

    def __init__(self):
        self.datas: dict[str, list] = defaultdict(list)

    def reset(self) -> None:
        self.datas = defaultdict(list)

    def add(self, pred_data, gt_data, frame=None) -> None:
        raise NotImplementedError

    def gather_distributed(self, arrays_by_rank: list[dict]) -> None:
        """Merge the `datas` of every rank (gathered by the caller)."""
        for datas in arrays_by_rank:
            for k, v in datas.items():
                self.datas[k].extend(v)


class _Meter(Meter):
    def __init__(self, mesh_db, n_points: int):
        super().__init__()
        self.mesh_db = mesh_db
        self.n_points = n_points

    def _matched(self, pred_data: TensorCollection, gt_data: TensorCollection, pred_ids, gt_ids):
        """Meshes, points, poses and intrinsics of the matched rows, on the
        mesh database's device."""
        dev = self.mesh_db.device
        labels = [gt_data.labels[i] for i in gt_ids]
        meshes = self.mesh_db.select(self.mesh_db.label_to_index(labels))
        rows = lambda t, ids: t[torch.as_tensor(ids, device=t.device)].to(dev, torch.float32)
        return (meshes, meshes.points[:, : self.n_points], rows(pred_data.poses, pred_ids),
                rows(gt_data.poses, gt_ids), rows(gt_data.K, gt_ids))

    def _diameters(self, gt_data: TensorCollection, ids) -> list[float]:
        labels = [gt_data.labels[i] for i in ids]
        return self.mesh_db.diameters[self.mesh_db.label_to_index(labels)].cpu().tolist()


class BOPScoreMeter(_Meter):
    """BOP19 average recall. AR_MSSD averages recall over thresholds
    {0.05..0.5} x object diameter; AR_MSPD over {5..50} px x
    (image_width / 640); AR_VSD over the VSD grid (frames with depth)."""

    def __init__(self, mesh_db, image_width: int = 640, n_points: int = 500):
        super().__init__(mesh_db, n_points)
        self.image_width = image_width

    def add(self, pred_data: TensorCollection, gt_data: TensorCollection, frame=None) -> None:
        pred_ids, gt_ids, missed = match_predictions(pred_data.infos, gt_data.infos)
        with_depth = frame is not None and frame.depth is not None
        if len(pred_ids):
            meshes, pts, TCO_pred, TCO_gt, K = self._matched(pred_data, gt_data, pred_ids, gt_ids)
            errs = compute_mssd_mspd(TCO_pred, TCO_gt, pts, K, meshes.symmetries, meshes.sym_valid)
            self.datas["mssd"].extend(_finite_or_inf(errs["mssd"]))
            self.datas["mspd"].extend(_finite_or_inf(errs["mspd"]))
            diam = meshes.diameters
            self.datas["diameter"].extend(diam.cpu().tolist())
            if with_depth:
                e_vsd = compute_vsd(frame.depth, TCO_pred, TCO_gt, K[0], meshes, diam)  # [N, n_taus]
                self.datas["vsd"].extend(e_vsd.tolist())
        if len(missed):
            self.datas["mssd"].extend([np.inf] * len(missed))
            self.datas["mspd"].extend([np.inf] * len(missed))
            self.datas["diameter"].extend(self._diameters(gt_data, missed))
            if with_depth:
                self.datas["vsd"].extend([[np.inf] * len(BOP19_VSD_TAUS)] * len(missed))

    def summary(self) -> dict[str, float]:
        mssd = np.asarray(self.datas["mssd"])
        mspd = np.asarray(self.datas["mspd"])
        diam = np.asarray(self.datas["diameter"])
        n = max(len(mssd), 1)
        rec_mssd = [float((mssd < t * diam).sum() / n) for t in np.arange(0.05, 0.51, 0.05)]
        scale = self.image_width / 640.0
        rec_mspd = [float((mspd < t * scale).sum() / n) for t in np.arange(5.0, 50.1, 5.0)]
        out = {
            "n": int(len(mssd)),
            "AR_MSSD": float(np.mean(rec_mssd)) if len(mssd) else 0.0,
            "AR_MSPD": float(np.mean(rec_mspd)) if len(mssd) else 0.0,
            "mssd_median": float(np.median(mssd)) if len(mssd) else float("nan"),
            "mspd_median": float(np.median(mspd)) if len(mssd) else float("nan"),
        }
        if self.datas["vsd"]:
            out["AR_VSD"] = vsd_recall(np.asarray(self.datas["vsd"]))
            out["AR"] = float(np.mean([out["AR_VSD"], out["AR_MSSD"], out["AR_MSPD"]]))
        else:
            out["AR"] = float(np.mean([out["AR_MSSD"], out["AR_MSPD"]]))
        return out


class ModelNetErrorMeter(_Meter):
    """ADD < 0.1 diameter, 5 deg / 5 cm and proj2d < 5 px."""

    def __init__(self, mesh_db, sample_n_points: int = 500):
        super().__init__(mesh_db, sample_n_points)

    def add(self, pred_data: TensorCollection, gt_data: TensorCollection, frame=None) -> None:
        pred_ids, gt_ids, missed = match_predictions(pred_data.infos, gt_data.infos)
        if len(pred_ids):
            meshes, pts, TCO_pred, TCO_gt, K = self._matched(pred_data, gt_data, pred_ids, gt_ids)
            errs = compute_errors(TCO_pred, TCO_gt, pts, K)
            for k in ("add", "rot_err_deg", "trans_err", "proj2d"):
                self.datas[k].extend(errs[k].tolist())
            self.datas["diameter"].extend(meshes.diameters.cpu().tolist())
        for k in ("add", "rot_err_deg", "trans_err", "proj2d"):  # misses: infinite error
            self.datas[k].extend([np.inf] * len(missed))
        self.datas["diameter"].extend(self._diameters(gt_data, missed))

    def summary(self) -> dict[str, float]:
        add = np.asarray(self.datas["add"])
        diam = np.asarray(self.datas["diameter"])
        rot = np.asarray(self.datas["rot_err_deg"])
        trans = np.asarray(self.datas["trans_err"])
        proj = np.asarray(self.datas["proj2d"])
        n = max(len(add), 1)
        finite = np.isfinite(add)
        return {
            "n": int(len(add)),
            "n_missed": int((~finite).sum()),
            "ADD_0.1d": float((add < 0.1 * diam).sum() / n),
            "5deg_5cm": float(((rot < 5.0) & (trans < 0.05)).sum() / n),
            "proj2d_5px": float((proj < 5.0).sum() / n),
            "add_mean": float(add[finite].mean()) if finite.any() else float("nan"),
        }
