"""Render outputs and screen projection shared by the renderers.

Counterpart of `RenderOutput`, `project_to_screen`,
`sample_textures_bilinear` and `apply_uv_as_colors` in
`megapose6d_tpu/ops/rasterizer.py` (the scan renderer waits).
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


def sample_textures_bilinear(textures: Tensor, uv: Tensor) -> Tensor:
    """Per-image bilinear texture lookup. `textures [B, TS, TS, 3]` uint8,
    `uv [B, H, W, 2]` in [0, 1] (u right, v down) -> `[B, H, W, 3]` float
    in [0, 1]. Each image samples one object's texture."""
    B, TS = textures.shape[0], textures.shape[1]
    H, W = uv.shape[1], uv.shape[2]
    x = (uv[..., 0] * TS - 0.5).clamp(0.0, TS - 1.0)
    y = (uv[..., 1] * TS - 0.5).clamp(0.0, TS - 1.0)
    x0, y0 = x.floor().long(), y.floor().long()
    x1, y1 = (x0 + 1).clamp_max(TS - 1), (y0 + 1).clamp_max(TS - 1)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    flat = textures.reshape(B, TS * TS, 3).float() / 255.0

    def texel(yy, xx):
        idx = (yy * TS + xx).reshape(B, H * W, 1).expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(B, H, W, 3)

    top = texel(y0, x0) * (1 - fx) + texel(y0, x1) * fx
    bot = texel(y1, x0) * (1 - fx) + texel(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def apply_uv_as_colors(colors: Tensor, uvs: Tensor | None, has_tex: Tensor | None) -> Tensor:
    """For textured meshes, (u, v, 0) in the colour attribute slots
    `[B, V, 3]`: each image renders one object, so the slots can switch
    meaning per image at no cost to the rasterizer."""
    if uvs is None or has_tex is None:
        return colors
    uv3 = torch.cat([uvs, torch.zeros_like(uvs[..., :1])], dim=-1)
    return torch.where(has_tex[:, None, None], uv3, colors)
