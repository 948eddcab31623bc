"""Scene dataset: annotated frames indexed by (scene_id, view_id).

Counterpart of `megapose6d_tpu/data/scene_dataset.py`. The frame index is
a pair of numpy columns instead of a DataFrame. The two endless iterators
draw from `random.Random(seed)` in the JAX package's order, so one seed
gives the same frames.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator, Sequence

import numpy as np

from .types import CameraData, ObjectData


@dataclasses.dataclass
class ObservationInfos:
    scene_id: str = ""
    view_id: int = -1


@dataclasses.dataclass
class SceneObservation:
    """One annotated frame: `rgb [H, W, 3]` uint8, `depth [H, W]` float32
    meters or None, `segmentation [H, W]` uint32 instance map or None."""

    rgb: np.ndarray | None = None
    depth: np.ndarray | None = None
    segmentation: np.ndarray | None = None
    infos: ObservationInfos = dataclasses.field(default_factory=ObservationInfos)
    object_datas: list[ObjectData] = dataclasses.field(default_factory=list)
    camera_data: CameraData = dataclasses.field(default_factory=CameraData)

    def gt_detections(self, min_visib_fract: float = 0.0) -> list[ObjectData]:
        """The objects usable as ground-truth detections (those with a
        visible box, at least `min_visib_fract` visible)."""
        return [
            o for o in self.object_datas
            if o.bbox_modal is not None
            and (o.visib_fract is None or o.visib_fract >= min_visib_fract)
        ]


@dataclasses.dataclass
class FrameIndex:
    """The frames of a dataset: `scene_id [N]` (str) and `view_id [N]`
    (int), in dataset order."""

    scene_id: np.ndarray
    view_id: np.ndarray

    def __len__(self) -> int:
        return len(self.view_id)

    def take(self, ids) -> "FrameIndex":
        return FrameIndex(self.scene_id[ids], self.view_id[ids])


class SceneDataset:
    """Map-style dataset over a frame index."""

    def __init__(self, frame_index: FrameIndex, load_depth: bool = False,
                 load_segmentation: bool = True):
        self.frame_index = frame_index
        self.load_depth = load_depth
        self.load_segmentation = load_segmentation

    def __len__(self) -> int:
        return len(self.frame_index)

    def _load_scene_observation(self, infos: ObservationInfos) -> SceneObservation:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> SceneObservation:
        fi = self.frame_index
        infos = ObservationInfos(scene_id=str(fi.scene_id[idx]), view_id=int(fi.view_id[idx]))
        return self._load_scene_observation(infos)

    def __iter__(self) -> Iterator[SceneObservation]:
        for i in range(len(self)):
            yield self[i]


class RandomIterableSceneDataset:
    """Endless frames of `scene_ds`, each drawn uniformly at random."""

    def __init__(self, scene_ds: SceneDataset, seed: int = 0):
        self.scene_ds = scene_ds
        self.rng = random.Random(seed)

    def __iter__(self) -> Iterator[SceneObservation]:
        while True:
            yield self.scene_ds[self.rng.randrange(len(self.scene_ds))]


class IterableMultiSceneDataset:
    """Endless frames from a random choice among endless iterators."""

    def __init__(self, datasets: Sequence, seed: int = 0):
        self.iterators = [iter(d) for d in datasets]
        self.rng = random.Random(seed)

    def __iter__(self) -> Iterator[SceneObservation]:
        while True:
            yield next(self.rng.choice(self.iterators))
