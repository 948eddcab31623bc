"""SE(3) / SO(3) primitives on `[..., 4, 4]` homogeneous tensors.

Counterpart of `megapose6d_tpu/ops/se3.py`. Conventions: transforms act on
column vectors (`x_out = R @ x + t`); quaternions are xyzw.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def transform_pts(T: Tensor, pts: Tensor) -> Tensor:
    """Apply `T [..., 4, 4]` (or `[..., S, 4, 4]`) to `pts [..., N, 3]`."""
    if T.ndim == pts.ndim + 1:
        pts = pts[..., None, :, :]
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def make_se3(R: Tensor, t: Tensor) -> Tensor:
    """Assemble `[..., 4, 4]` from `R [..., 3, 3]` and `t [..., 3]`."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def invert_se3(T: Tensor) -> Tensor:
    """Closed-form inverse of an SE(3) batch."""
    R_inv = T[..., :3, :3].transpose(-2, -1)
    t_inv = -(R_inv @ T[..., :3, 3:4])
    return make_se3(R_inv, t_inv[..., 0])


def rotmat_from_ortho6d(poses: Tensor) -> Tensor:
    """Continuous 6D rotation (Zhou et al. 2019) -> `[..., 3, 3]`; the
    matrix columns are (x, y, z)."""
    x_raw = poses[..., 0:3]
    y_raw = poses[..., 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True).clamp_min(1e-12)
    z = torch.linalg.cross(x, y_raw)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def se3_from_pose9d(pose9d: Tensor) -> Tensor:
    """9D pose (ortho6d rotation + translation) -> `[..., 4, 4]`."""
    return make_se3(rotmat_from_ortho6d(pose9d[..., :6]), pose9d[..., 6:9])


def normalize_T(T: Tensor) -> Tensor:
    """Re-orthonormalize the rotation block via the ortho6d round-trip."""
    pose9d = torch.cat([T[..., :3, 0], T[..., :3, 1], T[..., :3, 3]], dim=-1)
    return se3_from_pose9d(pose9d)


def rotmat_from_quat(q: Tensor) -> Tensor:
    """Unit quaternion (xyzw) `[..., 4]` -> rotation matrix `[..., 3, 3]`."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_from_euler_sxyz(euler: Tensor) -> Tensor:
    """Static-frame XYZ euler angles -> `R = Rz @ Ry @ Rx`."""
    ax, ay, az = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)
    shape = euler.shape[:-1] + (3, 3)
    Rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1)
    Ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1)
    Rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1)
    return Rz.reshape(shape) @ (Ry.reshape(shape) @ Rx.reshape(shape))

