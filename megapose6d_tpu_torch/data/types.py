"""Observation tensor.

Counterpart of `ObservationTensor` in `megapose6d_tpu/data/types.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ObservationTensor:
    """A batch of images + intrinsics: `images [B, H, W, C]` float32 with
    rgb in [0, 1] (NHWC, as in the JAX package), `K [B, 3, 3]` float32."""

    images: torch.Tensor
    K: torch.Tensor

    def __post_init__(self):
        if self.images.ndim != 4 or tuple(self.K.shape) != (self.images.shape[0], 3, 3):
            raise ValueError(f"bad shapes: images {tuple(self.images.shape)}, K {tuple(self.K.shape)}")

    @property
    def batch_size(self) -> int:
        return self.images.shape[0]

    @staticmethod
    def from_numpy(
        rgb: np.ndarray, K: np.ndarray, device: str | torch.device = "cuda"
    ) -> "ObservationTensor":
        """From one HWC rgb image (uint8, or float in [0, 1]) and its K."""
        if rgb.ndim != 3 or rgb.shape[-1] != 3:
            raise ValueError(f"expected an HWC rgb image, got {rgb.shape}")
        img = rgb.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        return ObservationTensor(
            images=torch.as_tensor(img[None], device=device),
            K=torch.as_tensor(np.asarray(K, np.float32)[None], device=device),
        )
