"""Object and camera annotations, and the observation tensor.

Counterpart of `ObjectData`, `CameraData` and `ObservationTensor` in
`megapose6d_tpu/data/types.py` (the fields the port reads), with the same
JSON: a pose is `[[qx, qy, qz, qw], [tx, ty, tz]]`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..ops import se3


def _pose_to_list(T: np.ndarray) -> list:
    q = se3.quat_from_rotmat(torch.as_tensor(np.asarray(T)[:3, :3], dtype=torch.float32)).numpy()
    return [q.tolist(), np.asarray(T)[:3, 3].tolist()]


def _pose_from_list(item: list) -> np.ndarray:
    quat, trans = item
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = se3.rotmat_from_quat(torch.as_tensor(quat, dtype=torch.float32)).numpy()
    T[:3, 3] = trans
    return T


@dataclasses.dataclass
class ObjectData:
    """One annotated object instance of a frame."""

    label: str
    TWO: np.ndarray | None = None  # [4, 4], world == camera for BOP frames
    unique_id: int | None = None
    bbox_amodal: np.ndarray | None = None  # [4] xyxy
    bbox_modal: np.ndarray | None = None  # [4] xyxy, the visible part
    visib_fract: float | None = None
    TWO_init: np.ndarray | None = None  # [4, 4], an external initial pose (DeepIM's on ModelNet)

    def to_json(self) -> dict:
        d: dict = {"label": self.label}
        for k in ("TWO", "TWO_init"):
            if getattr(self, k) is not None:
                d[k] = _pose_to_list(getattr(self, k))
        for k in ("bbox_amodal", "bbox_modal"):
            if getattr(self, k) is not None:
                d[k] = np.asarray(getattr(self, k)).tolist()
        for k in ("visib_fract", "unique_id"):
            if getattr(self, k) is not None:
                d[k] = getattr(self, k)
        return d

    @staticmethod
    def from_json(d: dict) -> "ObjectData":
        data = ObjectData(label=d["label"], unique_id=d.get("unique_id"), visib_fract=d.get("visib_fract"))
        for k in ("TWO", "TWO_init"):
            if k in d:
                setattr(data, k, _pose_from_list(d[k]))
        for k in ("bbox_amodal", "bbox_modal"):
            if k in d:
                setattr(data, k, np.array(d[k], dtype=np.float64))
        return data


def object_data_from_json_path(path: str | Path) -> list[ObjectData]:
    return [ObjectData.from_json(d) for d in json.loads(Path(path).read_text())]


def object_data_to_json_path(objects: list[ObjectData], path: str | Path) -> None:
    Path(path).write_text(json.dumps([o.to_json() for o in objects]))


@dataclasses.dataclass
class CameraData:
    """A frame's camera; `TWC` is its pose in the world (None: the world is
    the camera's frame, as in BOP)."""

    K: np.ndarray | None = None  # [3, 3]
    resolution: tuple[int, int] | None = None  # (h, w)
    TWC: np.ndarray | None = None  # [4, 4]

    def to_json(self) -> str:
        d: dict = {}
        if self.TWC is not None:
            d["TWC"] = _pose_to_list(self.TWC)
        if self.K is not None:
            d["K"] = np.asarray(self.K).tolist()
        if self.resolution is not None:
            d["resolution"] = list(self.resolution)
        return json.dumps(d)

    @staticmethod
    def from_json(data_str: str) -> "CameraData":
        d = json.loads(data_str)
        data = CameraData()
        if "TWC" in d:
            data.TWC = _pose_from_list(d["TWC"])
        if "K" in d:
            data.K = np.array(d["K"], dtype=np.float64)
        if "resolution" in d:
            data.resolution = (int(d["resolution"][0]), int(d["resolution"][1]))
        return data


@dataclasses.dataclass
class ObservationTensor:
    """A batch of images + intrinsics: `images [B, H, W, C]` float32 with
    rgb in [0, 1] and, when C is 4, metric depth as the 4th channel (NHWC,
    as in the JAX package); `K [B, 3, 3]` float32."""

    images: torch.Tensor
    K: torch.Tensor

    def __post_init__(self):
        if (self.images.ndim != 4 or self.images.shape[-1] not in (3, 4)
                or tuple(self.K.shape) != (self.images.shape[0], 3, 3)):
            raise ValueError(f"bad shapes: images {tuple(self.images.shape)}, K {tuple(self.K.shape)}")

    @property
    def batch_size(self) -> int:
        return self.images.shape[0]

    @property
    def channels(self) -> int:
        return self.images.shape[-1]

    @property
    def depth(self) -> torch.Tensor | None:
        """`[B, H, W]` metres, or None without a depth channel."""
        return self.images[..., 3] if self.channels == 4 else None

    @staticmethod
    def from_numpy(
        rgb: np.ndarray,
        K: np.ndarray,
        device: str | torch.device = "cuda",
        depth: np.ndarray | None = None,
    ) -> "ObservationTensor":
        """From one HWC rgb image (uint8, or float in [0, 1]), its K and
        optionally its HW depth in metres."""
        if rgb.ndim != 3 or rgb.shape[-1] != 3:
            raise ValueError(f"expected an HWC rgb image, got {rgb.shape}")
        img = rgb.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if depth is not None:
            if depth.shape != rgb.shape[:2]:
                raise ValueError(f"depth {depth.shape} does not match rgb {rgb.shape}")
            img = np.concatenate([img, depth.astype(np.float32)[..., None]], axis=-1)
        return ObservationTensor(
            images=torch.as_tensor(img[None], device=device),
            K=torch.as_tensor(np.asarray(K, np.float32)[None], device=device),
        )
