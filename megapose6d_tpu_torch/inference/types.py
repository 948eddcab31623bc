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
    """Detections: labels + `bboxes [D, 4]` (x1, y1, x2, y2) + `scores [D]`."""
    n = len(labels)
    bboxes = torch.as_tensor(np.asarray(bboxes, np.float32).reshape(n, 4), device=device)
    scores = torch.ones(n) if scores is None else torch.as_tensor(np.asarray(scores, np.float32))
    return TensorCollection(labels, bboxes=bboxes, scores=scores.to(device))
