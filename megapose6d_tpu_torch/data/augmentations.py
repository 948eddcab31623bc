"""Scene-observation augmentations of the training input pipeline.

Counterpart of `megapose6d_tpu/data/augmentations.py`, without PIL: the
same transforms, class names and defaults, drawing from the global
`random` and `np.random` in the same order, so one seed fires the same
transforms with the same factors. PIL's arithmetic (resizes, the box-blur
"Gaussian", the SMOOTH filter, `ImageEnhance`'s blends) is redone in numpy
by `utils/imaging.py`, bit for bit. They run on the host, in the batch
loader's workers.

`DepthBlurTransform` raises, as the JAX package's does: PIL's GaussianBlur
refuses float images ("image has wrong mode").
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Sequence

import numpy as np

from ..native import decode_image
from ..utils import imaging
from .scene_dataset import SceneObservation


class SceneObservationTransform:
    def __call__(self, obs: SceneObservation) -> SceneObservation:
        raise NotImplementedError


class SceneObsAug(SceneObservationTransform):
    """`transform` with probability `p` (one `random.random()` draw); a list
    of transforms runs in order."""

    def __init__(self, transform, p: float = 1.0):
        self.transform = ComposedTransform(transform) if isinstance(transform, (list, tuple)) else transform
        self.p = p

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        if random.random() <= self.p:
            return self.transform(obs)
        return obs


class ComposedTransform(SceneObservationTransform):
    def __init__(self, transforms: Sequence[SceneObservationTransform]):
        self.transforms = list(transforms)

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        for t in self.transforms:
            obs = t(obs)
        return obs


# ---------------------------------------------------------------------------
# RGB: PIL's ImageEnhance and GaussianBlur
# ---------------------------------------------------------------------------


class _Enhancer:
    """PIL's `ImageEnhance.<kind>(img)` on a uint8 array: `enhance(factor)`
    blends the image with its degenerate image."""

    def __init__(self, rgb: np.ndarray, degenerate: np.ndarray):
        self.rgb, self.degenerate = rgb, degenerate

    def enhance(self, factor: float) -> np.ndarray:
        return imaging.blend(self.degenerate, self.rgb, factor)


class _PillowEnhance(SceneObservationTransform):
    """`ImageEnhance.<kind>(img).enhance(factor)`: a blend of the image with
    its degenerate image, the factor drawn uniformly from the interval."""

    default_interval: tuple[float, float]

    def __init__(self, factor_interval: tuple[float, float] | None = None):
        self.factor_interval = factor_interval or self.default_interval

    @staticmethod
    def degenerate(rgb: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @classmethod
    def enhancer(cls, rgb: np.ndarray) -> _Enhancer:
        """The counterpart of the JAX package's `enhancer(img)`."""
        return _Enhancer(rgb, cls.degenerate(rgb))

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        factor = random.uniform(*self.factor_interval)
        return dataclasses.replace(obs, rgb=self.enhancer(obs.rgb).enhance(factor))


class PillowSharpness(_PillowEnhance):
    default_interval = (0.0, 50.0)

    @staticmethod
    def degenerate(rgb: np.ndarray) -> np.ndarray:
        return imaging.smooth(rgb)


class PillowContrast(_PillowEnhance):
    default_interval = (0.2, 50.0)

    @staticmethod
    def degenerate(rgb: np.ndarray) -> np.ndarray:
        # ImageStat's mean of the luma, rounded: an exact integer sum over a count.
        luma = imaging.luma(rgb)
        return np.full_like(rgb, int(float(luma.sum(dtype=np.int64)) / luma.size + 0.5))


class PillowBrightness(_PillowEnhance):
    default_interval = (0.1, 6.0)

    @staticmethod
    def degenerate(rgb: np.ndarray) -> np.ndarray:
        return np.zeros_like(rgb)


class PillowColor(_PillowEnhance):
    default_interval = (0.0, 20.0)

    @staticmethod
    def degenerate(rgb: np.ndarray) -> np.ndarray:
        return np.repeat(imaging.luma(rgb)[..., None], 3, axis=-1)


class PillowBlur(SceneObservationTransform):
    """PIL's GaussianBlur with an integer radius drawn from the interval."""

    def __init__(self, factor_interval: tuple[int, int] = (1, 3)):
        self.factor_interval = factor_interval

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        k = random.randint(*self.factor_interval)
        return dataclasses.replace(obs, rgb=imaging.gaussian_blur(obs.rgb, k))


# ---------------------------------------------------------------------------
# Depth corruption
# ---------------------------------------------------------------------------


class DepthGaussianNoiseTransform(SceneObservationTransform):
    def __init__(self, std_dev: float = 0.02):
        self.std_dev = std_dev

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        depth = np.array(obs.depth)
        noise = np.random.normal(scale=self.std_dev, size=depth.shape)
        depth[depth > 0] += noise[depth > 0]
        return dataclasses.replace(obs, depth=np.clip(depth, 0, None))


class DepthCorrelatedGaussianNoiseTransform(SceneObservationTransform):
    """Low-frequency noise: drawn on a grid `rescale` times coarser, resized
    bilinearly (PIL's float arithmetic) to the image."""

    def __init__(self, std_dev: float = 0.01, gp_rescale_factor_min: float = 15.0,
                 gp_rescale_factor_max: float = 40.0):
        self.std_dev = std_dev
        self.rescale = (gp_rescale_factor_min, gp_rescale_factor_max)

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        depth = np.array(obs.depth)
        H, W = depth.shape
        f = random.uniform(*self.rescale)
        small = (max(int(H / f), 2), max(int(W / f), 2))
        noise = np.random.normal(0.0, self.std_dev, small)
        noise_img = imaging.resize(noise.astype(np.float32), (H, W), "bilinear")
        depth[depth > 0] += noise_img[depth > 0]
        return dataclasses.replace(obs, depth=np.clip(depth, 0, None))


class DepthMissingTransform(SceneObservationTransform):
    """Zero a random fraction (up to `max_missing_fraction`) of the valid
    depth pixels."""

    def __init__(self, max_missing_fraction: float = 0.2):
        self.max_missing_fraction = max_missing_fraction

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        depth = np.array(obs.depth)
        v_idx = np.nonzero(depth.reshape(-1) > 0)[0]
        if len(v_idx):
            frac = random.uniform(0, self.max_missing_fraction)
            drop = np.random.choice(v_idx, int(len(v_idx) * frac), replace=False)
            flat = depth.reshape(-1)
            flat[drop] = 0
            depth = flat.reshape(depth.shape)
        return dataclasses.replace(obs, depth=depth)


class DepthDropoutTransform(SceneObservationTransform):
    """The whole depth image dropped."""

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        return dataclasses.replace(obs, depth=np.zeros_like(obs.depth))


def _random_ellipses(depth: np.ndarray, n_max: int = 10, gamma_shape: float = 5.0,
                     gamma_scale: float = 1.0) -> np.ndarray:
    H, W = depth.shape
    n = np.random.poisson(n_max * 0.5)
    ys = np.random.randint(0, H, n)
    xs = np.random.randint(0, W, n)
    rx = np.random.gamma(gamma_shape, gamma_scale, n).astype(int) + 1
    ry = np.random.gamma(gamma_shape, gamma_scale, n).astype(int) + 1
    ang = np.random.uniform(0, np.pi, n)
    yy, xx = np.mgrid[0:H, 0:W]
    mask = np.zeros((H, W), bool)
    for i in range(n):
        ca, sa = np.cos(ang[i]), np.sin(ang[i])
        dx, dy = xx - xs[i], yy - ys[i]
        xr = ca * dx + sa * dy
        yr = -sa * dx + ca * dy
        mask |= (xr / rx[i]) ** 2 + (yr / ry[i]) ** 2 <= 1.0
    return mask


class DepthEllipseDropoutTransform(SceneObservationTransform):
    """Random elliptical holes (sensor shadows)."""

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        depth = np.array(obs.depth)
        depth[_random_ellipses(depth)] = 0
        return dataclasses.replace(obs, depth=depth)


class DepthEllipseNoiseTransform(SceneObservationTransform):
    def __init__(self, std_dev: float = 0.01):
        self.std_dev = std_dev

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        depth = np.array(obs.depth)
        mask = _random_ellipses(depth) & (depth > 0)
        depth[mask] += np.random.normal(0, self.std_dev)
        return dataclasses.replace(obs, depth=np.clip(depth, 0, None))


class DepthBlurTransform(SceneObservationTransform):
    """PIL's GaussianBlur of the float depth, which PIL refuses: the radius
    is drawn, then this raises ValueError as the JAX package does."""

    def __init__(self, factor_interval: tuple[int, int] = (3, 7)):
        self.factor_interval = factor_interval

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        k = random.randint(*self.factor_interval)
        return dataclasses.replace(obs, depth=imaging.gaussian_blur(obs.depth.astype(np.float32), k))


class DepthBackgroundDropoutTransform(SceneObservationTransform):
    """Zero depth outside every object's mask."""

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        if obs.segmentation is None:
            raise ValueError("background dropout needs the observation's segmentation")
        depth = np.array(obs.depth)
        depth[obs.segmentation == 0] = 0
        return dataclasses.replace(obs, depth=depth)


# ---------------------------------------------------------------------------
# Background replacement
# ---------------------------------------------------------------------------


class ReplaceBackgroundTransform(SceneObservationTransform):
    """Pixels outside every object's mask from a random image of
    `image_paths`, resized bicubically (PIL's default) to the frame."""

    def __init__(self, image_paths: Sequence[str | Path]):
        self.image_paths = list(image_paths)
        if not self.image_paths:
            raise ValueError("no background images")

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        if obs.segmentation is None:
            raise ValueError("background replacement needs the observation's segmentation")
        H, W = obs.rgb.shape[:2]
        bg = imaging.resize(imaging.to_rgb8(decode_image(Path(random.choice(self.image_paths)).read_bytes())),
                          (H, W), "bicubic")
        rgb = np.array(obs.rgb)
        m = obs.segmentation == 0
        rgb[m] = bg[m]
        return dataclasses.replace(obs, rgb=rgb)


class VOCBackgroundAugmentation(ReplaceBackgroundTransform):
    """Backgrounds from Pascal VOC's `JPEGImages/*.jpg`."""

    def __init__(self, voc_root: str | Path):
        super().__init__(sorted(Path(voc_root).glob("JPEGImages/*.jpg")))


# ---------------------------------------------------------------------------
# Crop to the aspect ratio, then resize
# ---------------------------------------------------------------------------


class CropResizeToAspectTransform(SceneObservationTransform):
    """Centre-crop to the aspect ratio of `resize` (h, w, in either order)
    and resize: rgb bilinearly, depth and segmentation to the nearest
    pixel; K follows, and each object's visible box is recomputed from the
    segmentation (None when none of it is left)."""

    def __init__(self, resize: tuple[int, int] = (480, 640)):
        self.resize = (min(resize), max(resize))  # (h, w)

    def __call__(self, obs: SceneObservation) -> SceneObservation:
        h, w = obs.rgb.shape[:2]
        out_h, out_w = self.resize
        if (h, w) == (out_h, out_w):
            return obs
        target_aspect = out_w / out_h
        if w / h > target_aspect:
            crop_w, crop_h = int(round(h * target_aspect)), h
        else:
            crop_w, crop_h = w, int(round(w / target_aspect))
        x0, y0 = (w - crop_w) // 2, (h - crop_h) // 2
        crop = (slice(y0, y0 + crop_h), slice(x0, x0 + crop_w))

        rgb = imaging.resize(np.ascontiguousarray(obs.rgb[crop]), (out_h, out_w), "bilinear")
        depth = None
        if obs.depth is not None:
            depth = imaging.resize_nearest(obs.depth[crop].astype(np.float32), (out_h, out_w))
        seg = None
        if obs.segmentation is not None:
            seg = imaging.resize_nearest(obs.segmentation[crop].astype(np.int32), (out_h, out_w)).astype(np.uint32)

        sx, sy = out_w / crop_w, out_h / crop_h
        K = np.array(obs.camera_data.K, np.float64)
        K[0, 0] *= sx
        K[1, 1] *= sy
        K[0, 2] = (K[0, 2] - x0) * sx
        K[1, 2] = (K[1, 2] - y0) * sy
        camera_data = dataclasses.replace(obs.camera_data, K=K, resolution=(out_h, out_w))

        object_datas = []
        for obj in obs.object_datas:
            obj = dataclasses.replace(obj)
            if seg is not None and obj.unique_id is not None:
                ys, xs = np.nonzero(seg == obj.unique_id)
                obj.bbox_modal = (np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float64)
                                  if len(ys) else None)
            object_datas.append(obj)
        return dataclasses.replace(obs, rgb=rgb, depth=depth, segmentation=seg, camera_data=camera_data,
                                   object_datas=object_datas)


def make_rgb_augmentations() -> SceneObsAug:
    """The default RGB stack, applied with probability 0.8."""
    return SceneObsAug(
        [
            SceneObsAug(PillowBlur((1, 3)), p=0.4),
            SceneObsAug(PillowSharpness((0.0, 50.0)), p=0.3),
            SceneObsAug(PillowContrast((0.2, 50.0)), p=0.3),
            SceneObsAug(PillowBrightness((0.1, 6.0)), p=0.5),
            SceneObsAug(PillowColor((0.0, 20.0)), p=0.3),
        ],
        p=0.8,
    )


def make_depth_augmentations() -> SceneObsAug:
    """The default depth corruption stack."""
    return SceneObsAug(
        [
            SceneObsAug(DepthBlurTransform(), p=0.3),
            SceneObsAug(DepthEllipseDropoutTransform(), p=0.3),
            SceneObsAug(DepthGaussianNoiseTransform(0.01), p=0.3),
            SceneObsAug(DepthMissingTransform(0.2), p=0.3),
            SceneObsAug(DepthCorrelatedGaussianNoiseTransform(0.01), p=0.3),
        ],
        p=1.0,
    )
