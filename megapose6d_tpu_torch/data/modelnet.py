"""ModelNet evaluation frames with DeepIM's initial poses, and pickled
observations.

Counterpart of `megapose6d_tpu/data/modelnet.py`. Each frame pairs a
rendered ModelNet view (ground truth `TWO`) with DeepIM's initial
estimate (`TWO_init`), for the estimator's external initial poses
(`coarse_estimation_type="external"`). Layout:
  <root>/<category>/<split>/
    <model>_<view>-color.png
    <model>_<view>-depth.png          (uint16, over depth_scale)
    <model>_<view>-pose.txt           (4x4 ground-truth TWO, row-major)
    <model>_<view>-pose_init.txt      (4x4 DeepIM initial pose)
  <root>/<category>/camera.json       ({"K": ..., "resolution": [h, w]})
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from ..native import decode_image
from .scene_dataset import FrameIndex, ObservationInfos, SceneDataset, SceneObservation
from .types import CameraData, ObjectData


class DeepImModelNetDataset(SceneDataset):
    def __init__(self, root: str | Path, category: str, split: str = "test", load_depth: bool = False,
                 depth_scale: float = 1000.0, n_objects: int | None = None):
        self.root = Path(root)
        self.category = category
        self.split = split
        self.depth_scale = depth_scale
        self.base = self.root / category / split
        cam = json.loads((self.root / category / "camera.json").read_text())
        self.K = np.asarray(cam["K"], np.float64).reshape(3, 3)
        self.resolution = tuple(cam.get("resolution", (480, 640)))
        keys = sorted(p.name[: -len("-color.png")] for p in self.base.glob("*-color.png"))
        self.keys = keys[:n_objects] if n_objects is not None else keys
        super().__init__(FrameIndex(np.asarray([category] * len(self.keys), dtype=object),
                                    np.arange(len(self.keys), dtype=np.int64)), load_depth=load_depth)

    def _label(self, key: str) -> str:
        return f"modelnet_{self.category}_{key.rsplit('_', 1)[0]}"

    def __getitem__(self, idx: int) -> SceneObservation:
        key = self.keys[idx]
        rgb = decode_image((self.base / f"{key}-color.png").read_bytes())[..., :3]
        depth = None
        if self.load_depth:
            depth = decode_image((self.base / f"{key}-depth.png").read_bytes()).astype(np.float32) / self.depth_scale
        TWO = np.loadtxt(self.base / f"{key}-pose.txt").reshape(4, 4)
        init_path = self.base / f"{key}-pose_init.txt"
        TWO_init = np.loadtxt(init_path).reshape(4, 4) if init_path.exists() else None
        h, w = rgb.shape[:2]
        obj = ObjectData(label=self._label(key), TWO=TWO, TWO_init=TWO_init, unique_id=1,
                         bbox_modal=_bbox_from_pose(TWO, self.K, (h, w)), visib_fract=1.0)
        return SceneObservation(rgb=rgb, depth=depth, infos=ObservationInfos(scene_id=self.category, view_id=idx),
                                object_datas=[obj], camera_data=CameraData(K=self.K, resolution=(h, w)))


def _bbox_from_pose(TWO: np.ndarray, K: np.ndarray, hw: tuple[int, int], half_extent: float = 0.06) -> np.ndarray:
    """The box of the projected cube of `half_extent` around the object
    (ModelNet meshes are normalised; DeepIM evaluates with boxes centred
    on the ground truth), clipped to the image."""
    s = (-half_extent, half_extent)
    corners = np.array([[x, y, z, 1.0] for x in s for y in s for z in s])
    pc = (TWO @ corners.T).T[:, :3]
    z = np.maximum(pc[:, 2], 1e-3)
    u = K[0, 0] * pc[:, 0] / z + K[0, 2]
    v = K[1, 1] * pc[:, 1] / z + K[1, 2]
    h, w = hw
    return np.asarray([np.clip(u.min(), 0, w - 1), np.clip(v.min(), 0, h - 1),
                       np.clip(u.max(), 0, w - 1), np.clip(v.max(), 0, h - 1)])


class PickleSceneDataset(SceneDataset):
    """Pickled `SceneObservation`s, one a file, for debugging."""

    def __init__(self, paths: list[str | Path]):
        self.paths = [Path(p) for p in paths]
        super().__init__(FrameIndex(np.asarray(["0"] * len(self.paths), dtype=object),
                                    np.arange(len(self.paths), dtype=np.int64)))

    def __getitem__(self, idx: int) -> SceneObservation:
        with open(self.paths[idx], "rb") as fh:
            return pickle.load(fh)
