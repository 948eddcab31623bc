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
    detection_type: str = "gt"  # or "detector": boxes from a detector
    coarse_estimation_type: str = "SO3_grid"  # or "external": refine detections.TCO_init
    SO3_grid_size: int = 576
    # Hierarchical coarse scoring (0: off): the probe grid's size, and how
    # many of its best rotations have their Voronoi children scored.
    SO3_prune_grid_size: int = 0
    SO3_prune_keep: int = 8
    coarse_render_size: tuple[int, int] | None = None  # the sweep's raster resolution
    n_refiner_iterations: int = 5
    n_pose_hypotheses: int = 5
    run_depth_refiner: bool = False
    depth_refiner: str | None = None  # "ICP" or "teaserpp" (named models)
    bsz_images: int = 576  # coarse scoring chunk
    bsz_objects: int = 16  # refiner and rescoring chunk
    max_detections: int = 8  # detections kept per image (highest scores); the fused mode pads to it
    fused_pipeline: bool = False  # one program, no host synchronisation between phases
    rescore_f32: bool = False  # rescore refined hypotheses in float32


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
