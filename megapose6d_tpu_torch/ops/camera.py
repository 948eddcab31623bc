"""Pinhole-camera geometry, batched torch.

Counterpart of `megapose6d_tpu/ops/camera.py`. `K [..., 3, 3]` are OpenCV
intrinsics, `TCO [..., 4, 4]` camera<-object; pixel (u, v) = (column, row).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def project_points(points_3d: Tensor, K: Tensor, TCO: Tensor) -> Tensor:
    """Object-frame points `[B, N, 3]` -> pixels `[B, N, 2]`."""
    P = K @ TCO[..., :3, :]
    pts_h = torch.cat([points_3d, torch.ones_like(points_3d[..., :1])], dim=-1)
    suv = torch.einsum("...ij,...nj->...ni", P, pts_h)
    return suv[..., :2] / suv[..., 2:3]


def project_points_robust(
    points_3d: Tensor, K: Tensor, TCO: Tensor, z_min: float = 0.1
) -> Tensor:
    """Object-frame points `[B, N, 3]` -> pixels `[B, N, 2]`, with the
    camera depth clamped to `z_min` so hypotheses behind the camera stay
    finite."""
    P = K @ TCO[..., :3, :]
    pts_h = torch.cat([points_3d, torch.ones_like(points_3d[..., :1])], dim=-1)
    suv = torch.einsum("...ij,...nj->...ni", P, pts_h)
    z = suv[..., 2:3].clamp_min(z_min)
    return suv[..., :2] / z


def boxes_from_uv(uv: Tensor) -> Tensor:
    """Tight (x1, y1, x2, y2) box around `uv [B, N, 2]` -> `[B, 4]`."""
    return torch.cat([uv.amin(dim=-2), uv.amax(dim=-2)], dim=-1)


def masked_boxes_from_uv(uv: Tensor, valid: Tensor) -> Tensor:
    """Like `boxes_from_uv`, ignoring points where `valid [B, N]` is False."""
    big = torch.finfo(uv.dtype).max
    v = valid[..., None]
    mins = torch.where(v, uv, big).amin(dim=-2)
    maxs = torch.where(v, uv, -big).amax(dim=-2)
    return torch.cat([mins, maxs], dim=-1)


def get_K_crop_resize(
    K: Tensor, boxes: Tensor, crop_resize: tuple[int, int]
) -> Tensor:
    """Intrinsics of the crop `boxes [B, 4]` resized to `crop_resize`
    (h, w), pixel-center convention."""
    final_height, final_width = min(crop_resize), max(crop_resize)
    crop_width = boxes[..., 2] - boxes[..., 0]
    crop_height = boxes[..., 3] - boxes[..., 1]
    crop_cj = (boxes[..., 0] + boxes[..., 2]) / 2
    crop_ci = (boxes[..., 1] + boxes[..., 3]) / 2

    cx = K[..., 0, 2] + (crop_width - 1) / 2 - crop_cj
    cy = K[..., 1, 2] + (crop_height - 1) / 2 - crop_ci

    scale_x = final_width / crop_width
    scale_y = final_height / crop_height
    cx = (final_width - 1) / 2 + scale_x * (cx - (crop_width - 1) / 2)
    cy = (final_height - 1) / 2 + scale_y * (cy - (crop_height - 1) / 2)

    new_K = K.clone()
    new_K[..., 0, 0] = scale_x * K[..., 0, 0]
    new_K[..., 1, 1] = scale_y * K[..., 1, 1]
    new_K[..., 0, 2] = cx
    new_K[..., 1, 2] = cy
    return new_K


def get_K_resize(
    K: Tensor, orig_size: tuple[int, int], new_size: tuple[int, int]
) -> Tensor:
    """Intrinsics after resizing the whole image `orig_size -> new_size`
    (both (h, w)): fx' = s*fx, cx' = s*(cx+0.5)-0.5."""
    sy = new_size[0] / orig_size[0]
    sx = new_size[1] / orig_size[1]
    new_K = K.clone()
    new_K[..., 0, 0] = sx * K[..., 0, 0]
    new_K[..., 1, 1] = sy * K[..., 1, 1]
    new_K[..., 0, 2] = sx * (K[..., 0, 2] + 0.5) - 0.5
    new_K[..., 1, 2] = sy * (K[..., 1, 2] + 0.5) - 0.5
    return new_K


def look_at_R(
    eye: Tensor, target: Tensor, up_hint: Tensor, eps: float = 1e-9
) -> Tensor:
    """Rotation `R_WC` (columns = camera axes in world) of a CV camera at
    `eye` looking at `target`; the world `up_hint` maps to -y."""
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True).clamp_min(eps)
    x = torch.linalg.cross(-up_hint.expand_as(fwd), fwd)
    x_norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    fallback = torch.tensor([1.0, 0.0, 0.0], dtype=fwd.dtype, device=fwd.device)
    x = torch.where(x_norm < eps, fallback.expand_as(fwd), x / x_norm.clamp_min(eps))
    y = torch.linalg.cross(fwd, x)
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True).clamp_min(eps)
    return torch.stack([x, y, fwd], dim=-1)
