"""Inference configuration and detections.

Counterpart of `megapose6d_tpu/inference/types.py`; the defaults are the
same.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..data.tensor_collection import TensorCollection


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    detection_type: str = "gt"  # "detector": not ported yet
    coarse_estimation_type: str = "SO3_grid"  # "external": not ported yet
    SO3_grid_size: int = 576
    SO3_prune_grid_size: int = 0  # hierarchical coarse mode: not ported yet
    coarse_render_size: tuple[int, int] | None = None  # not ported yet
    n_refiner_iterations: int = 5
    n_pose_hypotheses: int = 5
    run_depth_refiner: bool = False  # not ported yet
    bsz_images: int = 576  # coarse scoring chunk
    bsz_objects: int = 16  # refiner and rescoring chunk
    max_detections: int = 8  # detections kept per image (highest scores)
    fused_pipeline: bool = False  # not ported yet
    rescore_f32: bool = False  # not ported yet


def make_detections(
    labels: Sequence[str],
    bboxes,
    scores=None,
    device: str | torch.device = "cuda",
) -> TensorCollection:
    """Detections: infos `label, score, batch_im_id, instance_id` (as the
    JAX package's `make_detections`) + `bboxes [D, 4]` (x1, y1, x2, y2)."""
    n = len(labels)
    bboxes = torch.as_tensor(np.asarray(bboxes, np.float32).reshape(n, 4), device=device)
    infos = {
        "label": list(labels),
        "score": np.ones(n) if scores is None else np.asarray(scores),
        "batch_im_id": np.zeros(n, np.int64),
        "instance_id": np.arange(n, dtype=np.int64),
    }
    return TensorCollection(infos=infos, bboxes=bboxes)
