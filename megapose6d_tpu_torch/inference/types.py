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
    batch_im_ids=None,
    device: str | torch.device = "cuda",
) -> TensorCollection:
    """Detections: infos `label, score, batch_im_id, instance_id` (as the
    JAX package's `make_detections`; `batch_im_id` 0 unless `batch_im_ids`
    names each detection's image) + `bboxes [D, 4]` (x1, y1, x2, y2)."""
    n = len(labels)
    bboxes = torch.as_tensor(np.asarray(bboxes, np.float32).reshape(n, 4), device=device)
    infos = {
        "label": list(labels),
        "score": np.ones(n) if scores is None else np.asarray(scores),
        "batch_im_id": np.zeros(n, np.int64) if batch_im_ids is None else np.asarray(batch_im_ids),
        "instance_id": np.arange(n, dtype=np.int64),
    }
    return TensorCollection(infos=infos, bboxes=bboxes)


def filter_detections(detections: TensorCollection, labels: Sequence[str] | None = None,
                      one_instance_per_class: bool = False) -> TensorCollection:
    """The detections whose label is in `labels` (all when None) and, with
    `one_instance_per_class`, only the highest-scoring of each label, in
    their order."""
    keep = np.ones(len(detections), bool)
    if labels is not None:
        keep &= np.isin(detections.infos["label"], list(labels))
    out = detections[np.nonzero(keep)[0]]
    if one_instance_per_class and len(out):
        seen: set[str] = set()
        sel = []
        for i in np.argsort(-out.infos["score"]):
            if out.infos["label"][i] not in seen:
                seen.add(out.infos["label"][i])
                sel.append(i)
        out = out[np.asarray(sorted(sel), np.int64)]
    return out


def add_instance_id(detections: TensorCollection) -> TensorCollection:
    """`instance_id`: each detection's rank among the earlier detections of
    its (`batch_im_id`, `label`)."""
    seen: dict[tuple, int] = {}
    ids = np.empty(len(detections), np.int64)
    for i, key in enumerate(zip(detections.infos["batch_im_id"], detections.infos["label"])):
        ids[i] = seen.get(key, 0)
        seen[key] = ids[i] + 1
    return TensorCollection(infos={**detections.infos, "instance_id": ids}, **detections.tensors)


def make_cameras(camera_datas, device: str | torch.device = "cuda") -> TensorCollection:
    """`CameraData`s -> infos `batch_im_id` + `K [N, 3, 3]` float32."""
    K = np.stack([np.asarray(c.K, np.float32) for c in camera_datas])
    return TensorCollection(infos={"batch_im_id": np.arange(len(camera_datas), dtype=np.int64)},
                            K=torch.as_tensor(K, device=device))


def make_pose_estimates(labels: Sequence[str], poses, extra_infos: dict | None = None,
                        device: str | torch.device = "cuda") -> TensorCollection:
    """Infos `label` (+ `extra_infos` columns) + `poses [N, 4, 4]` float32."""
    n = len(labels)
    poses = torch.as_tensor(np.asarray(poses, np.float32).reshape(n, 4, 4), device=device)
    return TensorCollection(infos={"label": list(labels), **(extra_infos or {})}, poses=poses)
