"""Prediction and evaluation runners.

Counterpart of `PredictionRunner` and `EvaluationRunner` in
`megapose6d_tpu/evaluation/runner.py`, on ground-truth boxes
(`detection_type="gt"`) or on a detector's (`"detector"`). A rank of
several predicts its share of the frames (`shard_frames`); the caller
merges the shares (`parallel.distributed.gather_collections`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.scene_dataset import SceneDataset, SceneObservation
from ..data.tensor_collection import TensorCollection, concatenate
from ..data.types import ObservationTensor
from ..inference.pose_estimator import PoseEstimator
from ..inference.types import make_detections


def shard_frames(n_frames: int, rank: int, world_size: int) -> np.ndarray:
    """Rank `rank`'s frames of `world_size`: the `np.array_split` of the
    frame ids (the reference's `DistributedSceneSampler`)."""
    return np.array_split(np.arange(n_frames), world_size)[rank]


class PredictionRunner:
    """The pipeline over a scene dataset's frames (rank `rank`'s share of
    them, then its first `n_frames`, as in the JAX package), on
    ground-truth boxes or on `detector`'s. A frame without a detection has
    no prediction."""

    def __init__(
        self,
        scene_ds: SceneDataset,
        estimator: PoseEstimator,
        rank: int = 0,
        world_size: int = 1,
        n_frames: int | None = None,
        detector=None,
        detection_type: str = "gt",
    ):
        if detection_type not in ("gt", "detector"):
            raise ValueError(f"detection_type must be gt or detector, not {detection_type!r}")
        if detection_type == "detector" and detector is None:
            raise ValueError("detection_type='detector' needs a detector")
        self.scene_ds = scene_ds
        self.estimator = estimator
        self.detector = detector
        self.detection_type = detection_type
        ids = shard_frames(len(scene_ds), rank, world_size)
        self.frame_ids = ids if n_frames is None else ids[:n_frames]

    def get_detections(self, obs: SceneObservation, observation: ObservationTensor) -> TensorCollection | None:
        """The frame's ground-truth boxes, or the detector's; None without any."""
        if self.detection_type == "gt":
            gt_objects = obs.gt_detections()
            if not gt_objects:
                return None
            return make_detections([o.label for o in gt_objects], np.stack([o.bbox_modal for o in gt_objects]),
                                   device=self.estimator.device)
        detections = self.detector.get_detections(observation)
        return detections if len(detections) else None

    def run_inference_on_observation(self, obs: SceneObservation):
        """(pose estimates, extra) of one frame, or None without detections."""
        observation = ObservationTensor.from_numpy(obs.rgb, K=obs.camera_data.K, device=self.estimator.device,
                                                   depth=obs.depth)
        detections = self.get_detections(obs, observation)
        if detections is None:
            return None
        return self.estimator.run_inference_pipeline(observation, detections)

    def get_predictions(self) -> dict[str, TensorCollection]:
        """Stage-keyed predictions on the CPU: `final` (one row per
        detection) and `refiner/iteration=N`, all K refined hypotheses of
        each detection after iteration N, with their `hypothesis_id` and
        the rescoring's `pose_logit`."""
        stages: dict[str, list[TensorCollection]] = {}
        for frame_id in self.frame_ids:
            obs = self.scene_ds[int(frame_id)]
            t0 = time.monotonic()
            result = self.run_inference_on_observation(obs)
            if result is None:
                continue
            data, extra = result
            elapsed = time.monotonic() - t0
            infos = {**data.infos, "scene_id": np.full(len(data), int(obs.infos.scene_id)),
                     "view_id": np.full(len(data), int(obs.infos.view_id)),
                     "time": np.full(len(data), elapsed)}
            stages.setdefault("final", []).append(TensorCollection(infos=infos, poses=data.poses.cpu()))
            traj = extra["refiner"]["trajectory"].cpu()  # [n_iter, D, K, 4, 4]
            n_iter, D, K = traj.shape[:3]
            logits = extra["refiner"]["pose_logits"].cpu().numpy().reshape(D * K)
            infos_k = {k: np.repeat(v, K) for k, v in infos.items()}
            infos_k["hypothesis_id"] = np.tile(np.arange(K), D)
            infos_k["pose_logit"] = logits
            for it in range(n_iter):
                stages.setdefault(f"refiner/iteration={it + 1}", []).append(
                    TensorCollection(infos=infos_k, poses=traj[it].reshape(D * K, 4, 4)))
        if not stages:
            return {"final": TensorCollection(infos={"label": []}, poses=torch.zeros((0, 4, 4)))}
        return {k: concatenate(v) for k, v in stages.items()}


def _norm_scene_id(s) -> str:
    """BOP scene dirs are zero-padded ("000048"), prediction infos carry ints."""
    s = str(s)
    return str(int(s)) if s.isdigit() else s


class EvaluationRunner:
    """Feeds the meters view by view."""

    def __init__(self, scene_ds: SceneDataset, meters: dict):
        self.scene_ds = scene_ds
        self.meters = meters

    def evaluate(self, predictions: TensorCollection) -> dict[str, dict]:
        rows = list(zip(predictions.infos["scene_id"].tolist(), predictions.infos["view_id"].tolist()))
        for scene_id, view_id in sorted(set(rows)):
            row_ids = [i for i, r in enumerate(rows) if r == (scene_id, view_id)]
            frame = self._find_frame(scene_id, int(view_id))
            gt_objects = frame.gt_detections()
            n = len(gt_objects)
            gt = TensorCollection(
                # instance_id follows the detection order fed to the
                # pipeline, so multi-instance scenes match one to one.
                infos={"label": [o.label for o in gt_objects], "instance_id": np.arange(n, dtype=np.int64)},
                poses=torch.as_tensor(np.stack([o.TWO for o in gt_objects]).astype(np.float32)),
                K=torch.as_tensor(np.tile(frame.camera_data.K[None].astype(np.float32), (n, 1, 1))),
            )
            pred = predictions[row_ids]
            for meter in self.meters.values():
                meter.add(pred, gt, frame=frame)
        return {k: m.summary() for k, m in self.meters.items()}

    def _find_frame(self, scene_id, view_id: int) -> SceneObservation:
        fi = self.scene_ds.frame_index
        hits = [i for i, (s, v) in enumerate(zip(fi.scene_id, fi.view_id))
                if _norm_scene_id(s) == _norm_scene_id(scene_id) and int(v) == view_id]
        if len(hits) != 1:
            raise ValueError(f"frame ({scene_id}, {view_id}) found {len(hits)} times")
        return self.scene_ds[hits[0]]
