"""Pose losses: symmetric point matching, the disentangled refiner loss,
ADD(-S).

Counterpart of `megapose6d_tpu/ops/losses.py`. Symmetry sets are padded
to a fixed size with a validity mask `sym_valid`, point sets with
`points_valid`.
"""

from __future__ import annotations

from typing import Callable

import torch

from .pose_init import pose_update_with_reference_point
from .se3 import make_se3, rotmat_from_ortho6d, transform_pts

Tensor = torch.Tensor

l1: Callable[[Tensor], Tensor] = lambda d: torch.abs(d)  # noqa: E731
l2: Callable[[Tensor], Tensor] = lambda d: d**2  # noqa: E731


def loss_CO_symmetric(
    TCO_possible_gt: Tensor,
    TCO_pred: Tensor,
    points: Tensor,
    l1_or_l2: Callable[[Tensor], Tensor] = l1,
    sym_valid: Tensor | None = None,
    points_valid: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Point-matching loss, least over the symmetries.

    `TCO_possible_gt [B, S, 4, 4]` (the ground truth composed with each
    symmetry), `TCO_pred [B, 4, 4]`, `points [B, N, 3]`, `sym_valid [B, S]`,
    `points_valid [B, N]`. Returns (loss `[B]`, the best-matching ground
    truth `[B, 4, 4]`)."""
    gt_pts = transform_pts(TCO_possible_gt, points)  # [B, S, N, 3]
    pred_pts = transform_pts(TCO_pred, points)  # [B, N, 3]
    diff = l1_or_l2(pred_pts[..., None, :, :] - gt_pts)  # [B, S, N, 3]
    if points_valid is not None:
        w = points_valid[..., None, :, None].to(diff.dtype)
        losses = (diff * w).sum((-1, -2)) / (w.sum((-1, -2)) * 3).clamp_min(1.0)
    else:
        losses = diff.mean((-1, -2))  # [B, S]
    if sym_valid is not None:
        losses = torch.where(sym_valid, losses, torch.finfo(losses.dtype).max)
    min_id = losses.argmin(dim=-1)
    loss = torch.gather(losses, -1, min_id[..., None])[..., 0]
    TCO_assign = torch.gather(
        TCO_possible_gt, -3, min_id[..., None, None, None].expand(min_id.shape + (1, 4, 4))
    )[..., 0, :, :]
    return loss, TCO_assign


def loss_refiner_CO_disentangled_reference_point(
    TCO_possible_gt: Tensor,
    TCO_input: Tensor,
    refiner_outputs: Tensor,
    K_crop: Tensor,
    points: Tensor,
    tCR: Tensor,
    sym_valid: Tensor | None = None,
    points_valid: Tensor | None = None,
) -> tuple[Tensor, dict[str, Tensor]]:
    """The DeepIM refiner loss about a reference point, disentangled: the
    rotation, xy and z parts of the 9D output are each scored with the
    other two set to their ground-truth values.

    `TCO_possible_gt [B, S, 4, 4]` (slot 0 the canonical ground truth),
    `TCO_input [B, 4, 4]`, `refiner_outputs [B, 9]`, `K_crop [B, 3, 3]`,
    `points [B, N, 3]`, `tCR [B, 3]`. Returns (loss `[B]`, the per-term
    losses)."""
    dR = rotmat_from_ortho6d(refiner_outputs[..., 0:6])
    vxvy = refiner_outputs[..., 6:8]
    vz = refiner_outputs[..., 8:9]
    TCO_gt = TCO_possible_gt[..., 0, :, :]
    R_gt, t_gt = TCO_gt[..., :3, :3], TCO_gt[..., :3, 3]
    fxfy = torch.stack([K_crop[..., 0, 0], K_crop[..., 1, 1]], dim=-1)

    dR_gt = R_gt @ TCO_input[..., :3, :3].transpose(-2, -1)
    tCR_out_gt = t_gt - torch.einsum("...ij,...j->...i", dR_gt, TCO_input[..., :3, 3] - tCR)
    vz_gt = tCR_out_gt[..., 2:3] / tCR[..., 2:3]
    vxvy_gt = fxfy * (tCR_out_gt[..., 0:2] / tCR_out_gt[..., 2:3] - tCR[..., 0:2] / tCR[..., 2:3])

    def update(vxvy_, vz_, dR_):
        return pose_update_with_reference_point(TCO_input, K_crop, torch.cat([vxvy_, vz_], -1), dR_, tCR)

    # Predicted rotation with ground-truth translation, then predicted xy
    # only, then predicted z only.
    TCO_pred_orn = make_se3(update(vxvy_gt, vz_gt, dR)[..., :3, :3], t_gt)
    T_xy = update(vxvy, vz_gt, dR_gt)
    TCO_pred_xy = make_se3(R_gt, torch.cat([T_xy[..., :2, 3], t_gt[..., 2:3]], -1))
    T_z = update(vxvy_gt, vz, dR_gt)
    TCO_pred_z = make_se3(R_gt, torch.cat([t_gt[..., :2], T_z[..., 2:3, 3]], -1))

    kw = dict(sym_valid=sym_valid, points_valid=points_valid, l1_or_l2=l1)
    loss_orn, _ = loss_CO_symmetric(TCO_possible_gt, TCO_pred_orn, points, **kw)
    loss_xy, _ = loss_CO_symmetric(TCO_possible_gt, TCO_pred_xy, points, **kw)
    loss_z, _ = loss_CO_symmetric(TCO_possible_gt, TCO_pred_z, points, **kw)
    loss = loss_orn + loss_xy + loss_z
    return loss, {"loss_orn": loss_orn, "loss_xy": loss_xy, "loss_z": loss_z, "loss": loss}


def dists_add(TCO_pred: Tensor, TCO_gt: Tensor, points: Tensor) -> Tensor:
    """Per-point ADD displacements `[B, N, 3]`."""
    return transform_pts(TCO_pred, points) - transform_pts(TCO_gt, points)


def dists_add_symmetric(TCO_pred: Tensor, TCO_gt: Tensor, points: Tensor) -> Tensor:
    """ADD-S: per predicted point, the displacement to the nearest ground
    truth point, `[B, N, 3]`."""
    pred = transform_pts(TCO_pred, points)
    gt = transform_pts(TCO_gt, points)
    d2 = ((pred[..., :, None, :] - gt[..., None, :, :]) ** 2).sum(-1)
    nn = d2.argmin(dim=-1)  # [B, N]
    gt_nn = torch.gather(gt, -2, nn[..., None].expand(nn.shape + (3,)))
    return pred - gt_nn


def compute_ADD_L1_loss(TCO_pred: Tensor, TCO_gt: Tensor, points: Tensor) -> Tensor:
    """Mean L1 ADD loss `[B]`."""
    return dists_add(TCO_pred, TCO_gt, points).abs().mean((-1, -2))
