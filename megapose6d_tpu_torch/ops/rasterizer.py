"""Render outputs and screen projection shared by the renderers.

Counterpart of `RenderOutput` and `project_to_screen` in
`megapose6d_tpu/ops/rasterizer.py` (the scan renderer and textures wait).
Conventions: OpenCV intrinsics, pixel (i, j) center at (u=j, v=i), depth in
meters with 0 = background, outputs NHWC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class RenderOutput(NamedTuple):
    rgb: Tensor  # [B, H, W, 3] in [0, 1]
    normals: Tensor  # [B, H, W, 3] in [0, 1] (eye-space, (n+1)/2)
    depth: Tensor  # [B, H, W] meters, 0 = background
    mask: Tensor  # [B, H, W] bool


def project_to_screen(vertices: Tensor, TCO: Tensor, K: Tensor, z_min: float = 1e-3) -> Tensor:
    """Object-frame vertices `[B, V, 3]` -> screen (u, v, z_cam) `[B, V, 3]`."""
    v_cam = torch.einsum("...ij,...nj->...ni", TCO[..., :3, :3], vertices) + TCO[..., None, :3, 3]
    z = v_cam[..., 2]
    z_safe = z.clamp_min(z_min)
    u = K[..., 0, 0, None] * v_cam[..., 0] / z_safe + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * v_cam[..., 1] / z_safe + K[..., 1, 2, None]
    return torch.stack([u, v, z], dim=-1)
