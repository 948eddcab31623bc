"""PoseDataset: training samples from scene observations.

Counterpart of `megapose6d_tpu/data/pose_dataset.py`. Per observation:
crop and resize to the input's aspect, augment, keep the objects that pass
the visibility, area and label filters, and take one at random
(`random.choice`, in the JAX package's order of draws); `collate_pose_data`
stacks samples into a `BatchPoseData` of numpy arrays on the host, which
`host_batch_to_torch` turns into CPU tensors for the trainer to copy to
the device.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator, Sequence

import numpy as np
import torch

from ..training.forward_loss import BatchPoseData
from .augmentations import (
    CropResizeToAspectTransform,
    ReplaceBackgroundTransform,
    SceneObsAug,
    SceneObservationTransform,
    make_depth_augmentations,
    make_rgb_augmentations,
)
from .scene_dataset import SceneObservation


@dataclasses.dataclass
class PoseData:
    """One training sample."""

    rgb: np.ndarray  # [H, W, 3] uint8
    K: np.ndarray  # [3, 3]
    TCO: np.ndarray  # [4, 4]
    bbox: np.ndarray  # [4] xyxy, the visible box
    label: str
    depth: np.ndarray | None = None  # [H, W] float32


class NoValidObjectError(RuntimeError):
    pass


class PoseDataset:
    def __init__(
        self,
        scene_ds,
        resize: tuple[int, int] = (480, 640),
        apply_rgb_augmentation: bool = True,
        apply_depth_augmentation: bool = False,
        apply_background_augmentation: bool = False,
        background_image_paths: Sequence[str] = (),
        min_area: float | None = None,
        keep_labels_set: set[str] | None = None,
        depth_supported: bool = False,
        extra_augmentations: Sequence[SceneObservationTransform] = (),
    ):
        self.scene_ds = scene_ds
        self.resize_transform = CropResizeToAspectTransform(resize)
        self.min_area = min_area
        self.keep_labels_set = keep_labels_set
        self.depth_supported = depth_supported
        self.augmentations: list[SceneObservationTransform] = []
        if apply_background_augmentation and background_image_paths:
            self.augmentations.append(SceneObsAug(ReplaceBackgroundTransform(background_image_paths), p=0.3))
        if apply_rgb_augmentation:
            self.augmentations.append(make_rgb_augmentations())
        if apply_depth_augmentation and depth_supported:
            self.augmentations.append(make_depth_augmentations())
        self.augmentations.extend(extra_augmentations)

    def _valid_objects(self, obs: SceneObservation) -> list:
        """Objects with a visible box, in the label set, of at least
        `min_area` px^2 and at least 5% visible."""
        valid = []
        for obj in obs.object_datas:
            if obj.bbox_modal is None:
                continue
            if self.keep_labels_set and obj.label not in self.keep_labels_set:
                continue
            b = obj.bbox_modal
            if self.min_area is not None and (b[2] - b[0]) * (b[3] - b[1]) < self.min_area:
                continue
            if obj.visib_fract is not None and obj.visib_fract < 0.05:
                continue
            valid.append(obj)
        return valid

    def make_data_from_obs(self, obs: SceneObservation) -> PoseData:
        obs = self.resize_transform(obs)
        for aug in self.augmentations:
            obs = aug(obs)
        valid = self._valid_objects(obs)
        if not valid:
            raise NoValidObjectError
        obj = random.choice(valid)
        # TCO = TWC^-1 TWO; the world is the camera when TWC is missing.
        TWO = np.asarray(obj.TWO, np.float64)
        if obs.camera_data.TWC is not None:
            TWC = np.asarray(obs.camera_data.TWC, np.float64)
            R = TWC[:3, :3]
            TCW = np.eye(4)
            TCW[:3, :3] = R.T
            TCW[:3, 3] = -R.T @ TWC[:3, 3]
            TCO = TCW @ TWO
        else:
            TCO = TWO
        return PoseData(
            rgb=obs.rgb, K=np.asarray(obs.camera_data.K, np.float32), TCO=TCO.astype(np.float32),
            bbox=np.asarray(obj.bbox_modal, np.float32), label=obj.label,
            depth=obs.depth if self.depth_supported else None,
        )

    def find_valid_data(self, iterator: Iterator[SceneObservation], n_attempts: int = 200) -> PoseData:
        """The first observation of `iterator` with a valid object."""
        for _ in range(n_attempts):
            try:
                return self.make_data_from_obs(next(iterator))
            except NoValidObjectError:
                continue
        raise ValueError(f"no valid data after {n_attempts} attempts")

    def iter_batches(self, obs_iterator: Iterator[SceneObservation], batch_size: int,
                     label_to_idx: dict[str, int]) -> Iterator[BatchPoseData]:
        """Endless host batches (numpy `BatchPoseData`)."""
        while True:
            samples = [self.find_valid_data(obs_iterator) for _ in range(batch_size)]
            yield collate_pose_data(samples, label_to_idx)


def collate_pose_data(samples: list[PoseData], label_to_idx: dict[str, int]) -> BatchPoseData:
    """Stack samples into a `BatchPoseData` of numpy arrays; uint8 rgb
    becomes float32 in [0, 1] (divided by 255 when the batch's largest
    value is above 1.5, as the JAX package does)."""
    rgbs = np.stack([s.rgb for s in samples]).astype(np.float32)
    if rgbs.max() > 1.5:
        rgbs = rgbs / 255.0
    depths = None
    if samples[0].depth is not None:
        depths = np.stack([s.depth for s in samples]).astype(np.float32)
    return BatchPoseData(
        rgbs=rgbs, K=np.stack([s.K for s in samples]), TCO=np.stack([s.TCO for s in samples]),
        bboxes=np.stack([s.bbox for s in samples]),
        mesh_idx=np.asarray([label_to_idx[s.label] for s in samples], np.int32), depths=depths,
    )


def host_batch_to_torch(batch: BatchPoseData) -> BatchPoseData:
    """A numpy `BatchPoseData` as CPU tensors (sharing memory), `mesh_idx`
    as int64."""
    conv = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    conv = {k: None if v is None else torch.as_tensor(v) for k, v in conv.items()}
    conv["mesh_idx"] = conv["mesh_idx"].long()
    return BatchPoseData(**conv)
