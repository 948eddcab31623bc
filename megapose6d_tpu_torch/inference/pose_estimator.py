"""PoseEstimator: the public inference pipeline (phased mode).

Counterpart of the phased path of `PoseEstimator.run_inference_pipeline`
in `megapose6d_tpu/inference/pose_estimator.py`:

  detections -> coarse scores of every (detection, SO(3)-grid rotation)
  hypothesis -> top-K -> K x N refiner iterations -> coarse re-scoring
  -> top-1 per detection.

The JAX package pads detections and chunks to static shapes; here the
batch dimensions are written out, loops are Python, and the last chunk is
simply shorter. Every hypothesis is computed independently, so the
results do not depend on the chunking. The fused and sharded modes, the
hierarchical prune, the coarse LOD database, low-resolution coarse
renders, f32 rescoring, external initial poses and depth refinement are
not ported yet and raise.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from ..data.tensor_collection import TensorCollection
from ..data.types import ObservationTensor
from ..meshes.mesh_db import BatchedMeshes
from ..models.pose_predictor import PosePredictor
from ..ops._precision import pin_f32
from ..ops.pose_init import tco_init_from_boxes_autodepth_with_R
from ..ops.so3_grid import make_so3_grid
from .types import InferenceConfig

Tensor = torch.Tensor


def _check_supported(cfg: InferenceConfig) -> None:
    unported = {
        "fused_pipeline": cfg.fused_pipeline,
        "SO3_prune_grid_size": cfg.SO3_prune_grid_size,
        "coarse_render_size": cfg.coarse_render_size,
        "rescore_f32": cfg.rescore_f32,
        "run_depth_refiner": cfg.run_depth_refiner,
        "coarse_estimation_type=external": cfg.coarse_estimation_type == "external",
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)}")


class PoseEstimator:
    """Coarse + refiner orchestration over one observation.

    Args:
      coarse_model / refiner_model: `PosePredictor`s (weights loaded).
      mesh_db: padded `BatchedMeshes` covering all labels in play.
      cfg: `InferenceConfig`.
      device: where the models, meshes and work live.
    """

    def __init__(
        self,
        coarse_model: PosePredictor,
        refiner_model: PosePredictor,
        mesh_db: BatchedMeshes,
        cfg: InferenceConfig = InferenceConfig(),
        device: str | torch.device = "cuda",
    ):
        _check_supported(cfg)
        pin_f32()
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.coarse_model = coarse_model.to(self.device).eval()
        self.refiner_model = refiner_model.to(self.device).eval()
        self.mesh_db = mesh_db
        if mesh_db.device != self.device:
            raise ValueError(f"mesh_db is on {mesh_db.device}, the estimator on {self.device}")
        self.cfg = cfg
        self.so3_grid = make_so3_grid(cfg.SO3_grid_size, device=self.device)
        self.timing_: dict[str, float] = {}

    def _clock(self) -> float:
        """Host time after the device has finished the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _score(self, chunk: int, images: Tensor, K: Tensor, TCO: Tensor, mesh_idx: Tensor) -> Tensor:
        """Coarse logits `[N]` of poses `TCO [N, 4, 4]`, `chunk` at a time."""
        logits = []
        for s in range(0, TCO.shape[0], chunk):
            T_c = TCO[s : s + chunk]
            out = self.coarse_model.score_views(
                images, K.expand(T_c.shape[0], 3, 3), T_c,
                self.mesh_db.select(mesh_idx[s : s + chunk]),
            )
            logits.append(out["logits"][:, 0])
        return torch.cat(logits)

    def coarse_logits(
        self, chunk: int, images: Tensor, K: Tensor, boxes: Tensor, mesh_idx: Tensor
    ) -> tuple[Tensor, Tensor]:
        """Score every (detection, grid rotation) hypothesis.

        Returns (logits `[D, M]`, TCO_init `[D, M, 4, 4]`)."""
        D, M = boxes.shape[0], self.so3_grid.shape[0]
        points = self.mesh_db.points[mesh_idx]  # [D, P, 3]
        TCO_init = tco_init_from_boxes_autodepth_with_R(
            boxes[:, None].expand(D, M, 4).reshape(D * M, 4),
            points[:, None].expand((D, M) + points.shape[1:]).reshape((D * M,) + points.shape[1:]),
            K.expand(D * M, 3, 3),
            self.so3_grid[None].expand(D, M, 3, 3).reshape(D * M, 3, 3),
        )
        logits = self._score(chunk, images, K, TCO_init, mesh_idx.repeat_interleave(M))
        return logits.reshape(D, M), TCO_init.reshape(D, M, 4, 4)

    def refine(
        self, chunk: int, n_iterations: int, images: Tensor, K: Tensor, TCO: Tensor,
        mesh_idx: Tensor,
    ) -> tuple[Tensor, Tensor]:
        """Run the refiner on `TCO [N, 4, 4]`, `chunk` hypotheses at a time.

        Returns (TCO_refined `[N, 4, 4]`, trajectory `[n_iter, N, 4, 4]`)."""
        finals, trajs = [], []
        for s in range(0, TCO.shape[0], chunk):
            T = TCO[s : s + chunk]
            meshes = self.mesh_db.select(mesh_idx[s : s + chunk])
            K_c = K.expand(T.shape[0], 3, 3)
            traj = []
            for _ in range(n_iterations):
                T = self.refiner_model.refine_step(images, K_c, T, meshes)["TCO_output"]
                traj.append(T)
            finals.append(T)
            trajs.append(torch.stack(traj))
        return torch.cat(finals), torch.cat(trajs, dim=1)

    @torch.inference_mode()
    def run_inference_pipeline(
        self,
        observation: ObservationTensor,
        detections: TensorCollection,
        n_refiner_iterations: int | None = None,
        n_pose_hypotheses: int | None = None,
    ) -> tuple[TensorCollection, dict[str, Any]]:
        """Full pipeline on ONE observation.

        Args:
          observation: batch size 1.
          detections: labels + `bboxes [D, 4]` (+ `scores [D]`).
        Returns:
          (labels + `poses [D, 4, 4]`, `pose_score [D]`, `pose_logit [D]`;
          extra data with per-phase timing and intermediate results).
        """
        cfg = self.cfg
        n_iter = n_refiner_iterations or cfg.n_refiner_iterations
        top_k = n_pose_hypotheses or cfg.n_pose_hypotheses
        if observation.batch_size != 1:
            raise ValueError("run_inference_pipeline takes one observation")
        if len(detections) == 0:
            raise ValueError("no detections")
        timing: dict[str, float] = {}
        t_start = self._clock()

        if len(detections) > cfg.max_detections:
            # Keep the highest-scoring rows, in their original order.
            scores = detections.tensors.get("scores")
            if scores is None:
                keep = torch.arange(cfg.max_detections)
            else:
                order = torch.sort(-scores.cpu(), stable=True).indices
                keep = torch.sort(order[: cfg.max_detections]).values
            detections = detections[keep]
        D = len(detections)
        mesh_idx = self.mesh_db.label_to_index(detections.labels)
        boxes = detections.bboxes.to(self.device, torch.float32)
        images = observation.images.to(self.device, torch.float32)
        K = observation.K.to(self.device, torch.float32)
        M = self.so3_grid.shape[0]

        t0 = self._clock()
        logits, TCO_init = self.coarse_logits(min(cfg.bsz_images, D * M), images, K, boxes, mesh_idx)
        timing["coarse"] = self._clock() - t0

        # Top-K, ties to the lower grid index (as jax.lax.top_k).
        top_ids = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :top_k]
        TCO_topk = torch.gather(TCO_init, 1, top_ids[..., None, None].expand(-1, -1, 4, 4))

        t0 = self._clock()
        N = D * top_k
        idx_flat = mesh_idx.repeat_interleave(top_k)
        chunk_r = min(cfg.bsz_objects, N)
        TCO_refined, traj = self.refine(
            chunk_r, n_iter, images, K, TCO_topk.reshape(N, 4, 4), idx_flat
        )
        timing["refiner"] = self._clock() - t0

        t0 = self._clock()
        pose_logits = self._score(chunk_r, images, K, TCO_refined, idx_flat)
        timing["scoring"] = self._clock() - t0

        pose_logits_dk = pose_logits.reshape(D, top_k)
        best = pose_logits_dk.argmax(dim=1)
        TCO_best = TCO_refined.reshape(D, top_k, 4, 4)[torch.arange(D, device=self.device), best]
        best_logit = pose_logits_dk[torch.arange(D, device=self.device), best]
        timing["total"] = self._clock() - t_start
        self.timing_ = timing

        poses = TensorCollection(
            detections.labels, poses=TCO_best, pose_score=torch.sigmoid(best_logit),
            pose_logit=best_logit,
        )
        extra = {
            "timing": timing,
            "coarse": {"logits": logits, "TCO_init": TCO_init, "top_ids": top_ids},
            "refiner": {
                "trajectory": traj.reshape(n_iter, D, top_k, 4, 4),
                "TCO_refined": TCO_refined.reshape(D, top_k, 4, 4),
                "pose_logits": pose_logits_dk,
            },
        }
        return poses, extra
