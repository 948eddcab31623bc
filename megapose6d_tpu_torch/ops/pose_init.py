"""Pose hypotheses from 2D boxes, and the network's SE(3) update.

Counterpart of `megapose6d_tpu/ops/pose_init.py`.
"""

from __future__ import annotations

import torch

from .se3 import make_se3, transform_pts

Tensor = torch.Tensor

# The coarse model's canonical seed rotation: object z up in the image.
_ZUP_R = ((0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (-1.0, 0.0, 0.0))


def tco_init_from_boxes_autodepth_with_R(
    boxes_2d: Tensor,
    model_points_3d: Tensor,
    K: Tensor,
    R: Tensor,
    z_guess: float = 1.0,
) -> Tensor:
    """Initial pose `[B, 4, 4]` for rotation `R [B, 3, 3]`, with depth set
    so the projected extent of `model_points_3d [B, N, 3]` matches the box
    `boxes_2d [B, 4]` (x1, y1, x2, y2); `K [B, 3, 3]`."""
    fxfy = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    cxcy = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
    centers = (boxes_2d[..., 0:2] + boxes_2d[..., 2:4]) / 2

    xy_init = (centers - cxcy) * z_guess / fxfy
    t0 = torch.cat([xy_init, torch.full_like(xy_init[..., :1], z_guess)], dim=-1)
    pts_cam = transform_pts(make_se3(R, t0), model_points_3d)
    deltax_3d = pts_cam[..., 0].amax(dim=-1) - pts_cam[..., 0].amin(dim=-1)
    deltay_3d = pts_cam[..., 1].amax(dim=-1) - pts_cam[..., 1].amin(dim=-1)

    bb_dx = boxes_2d[..., 2] - boxes_2d[..., 0] + 1
    bb_dy = boxes_2d[..., 3] - boxes_2d[..., 1] + 1
    z_from_dx = fxfy[..., 0] * deltax_3d / bb_dx
    z_from_dy = fxfy[..., 1] * deltay_3d / bb_dy
    z = (z_from_dx + z_from_dy) / 2

    xy = (centers - cxcy) * z[..., None] / fxfy
    return make_se3(R, torch.cat([xy, z[..., None]], dim=-1))


def tco_init_from_boxes_zup_autodepth(
    boxes_2d: Tensor, model_points_3d: Tensor, K: Tensor
) -> Tensor:
    """`tco_init_from_boxes_autodepth_with_R` at the z-up rotation."""
    R = torch.tensor(_ZUP_R, dtype=boxes_2d.dtype, device=boxes_2d.device)
    return tco_init_from_boxes_autodepth_with_R(
        boxes_2d, model_points_3d, K, R.expand(boxes_2d.shape[:-1] + (3, 3))
    )


def pose_update_with_reference_point(
    TCO: Tensor, K: Tensor, vxvyvz: Tensor, dRCO: Tensor, tCR: Tensor
) -> Tensor:
    """Apply the 9D head output about the reference point `tCR [B, 3]`:
    vz scales its depth, (vx, vy) move it in normalized image coordinates,
    `dRCO [B, 3, 3]` left-multiplies the rotation. Depths are clamped like
    the JAX package does."""
    zsrc = tCR[..., 2:3]
    zsrc = torch.where(zsrc.abs() < 1e-4, torch.full_like(zsrc, 1e-4), zsrc)
    ztgt = (vxvyvz[..., 2:3] * zsrc).clamp(1e-4, 1e4)

    fxfy = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    tCR_out_xy = (vxvyvz[..., 0:2] / fxfy + tCR[..., 0:2] / zsrc) * ztgt
    tCR_out = torch.cat([tCR_out_xy, ztgt], dim=-1)

    tCO_out = torch.einsum("...ij,...j->...i", dRCO, TCO[..., :3, 3] - tCR) + tCR_out
    return make_se3(dRCO @ TCO[..., :3, :3], tCO_out)
