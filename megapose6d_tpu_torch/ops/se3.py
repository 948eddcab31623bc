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
    # The row (0, 0, 0, 1) from the identity: no host data, so CUDA graphs can capture it.
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
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


def quat_from_rotmat(R: Tensor) -> Tensor:
    """Rotation matrix `[..., 3, 3]` -> unit quaternion (xyzw) `[..., 4]`
    with w >= 0 (Shepperd: the candidate of the largest 4 q_k^2)."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    q2 = torch.stack([
        1.0 + tr,
        1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
        1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
        1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
    ], -1).clamp_min(0.0)
    a21, a02, a10 = m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]
    s01, s02, s12 = m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1]
    cands = torch.stack([
        torch.stack([a21, a02, a10, q2[..., 0]], -1),
        torch.stack([q2[..., 1], s01, s02, a21], -1),
        torch.stack([s01, q2[..., 2], s12, a02], -1),
        torch.stack([s02, s12, q2[..., 3], a10], -1),
    ], -2)  # [..., 4 candidates, 4]
    best = q2.argmax(-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


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


def geodesic_distance(R1: Tensor, R2: Tensor) -> Tensor:
    """Angle (radians) between rotations `[..., 3, 3]`: acos of
    (trace(R1 R2^T) - 1) / 2, clipped to [-1, 1]."""
    m = R1 @ R2.transpose(-2, -1)
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    return torch.arccos(((tr - 1.0) / 2.0).clamp(-1.0, 1.0))


# ----------------------------------------------------------------------
# Random rotations and pose noise. Each is split into a draw (normals and
# uniforms from a `torch.Generator`) and an apply (a deterministic function
# of those draws), so the tests can feed the JAX package's own draws.
# ----------------------------------------------------------------------


def draw_random_rotations(shape: tuple[int, ...], generator: torch.Generator) -> Tensor:
    """Standard normal 4-vectors `shape + (4,)` for `random_rotations`."""
    return torch.randn(tuple(shape) + (4,), generator=generator)


def random_rotations(normals: Tensor) -> Tensor:
    """Haar-uniform rotations `[..., 3, 3]` from standard normal 4-vectors
    `[..., 4]` (normalised, they are uniform on S^3)."""
    return rotmat_from_quat(normals)


def draw_small_random_rotations(
    shape: tuple[int, ...], generator: torch.Generator
) -> tuple[Tensor, Tensor]:
    """(axis normals `shape + (3,)`, uniforms in [0, 1) `shape`) for
    `small_random_rotations`."""
    axis = torch.randn(tuple(shape) + (3,), generator=generator)
    return axis, torch.rand(tuple(shape), generator=generator)


def small_random_rotations(axis_normals: Tensor, uniforms: Tensor, max_angle_rad: float) -> Tensor:
    """Rotations by `uniforms * max_angle_rad` about the Haar-uniform axes
    `axis_normals / |axis_normals|`; `[..., 3, 3]`."""
    axis = axis_normals / (torch.linalg.norm(axis_normals, dim=-1, keepdim=True) + 1e-12)
    half = uniforms * (max_angle_rad / 2.0)
    q = torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], -1)  # xyzw
    return rotmat_from_quat(q)


def draw_pose_noise(n: int, generator: torch.Generator) -> tuple[Tensor, Tensor]:
    """(euler normals `[n, 3]`, translation normals `[n, 3]`) for
    `add_pose_noise`."""
    return torch.randn((n, 3), generator=generator), torch.randn((n, 3), generator=generator)


def add_pose_noise(
    TCO: Tensor,
    euler_normals: Tensor,
    trans_normals: Tensor,
    euler_deg_std: tuple[float, float, float] = (15.0, 15.0, 15.0),
    trans_std: tuple[float, float, float] = (0.01, 0.01, 0.05),
) -> Tensor:
    """`R_out = R @ R_noise(euler)`, `t_out = t + trans_normals * trans_std`,
    with static-frame XYZ euler angles `euler_normals * euler_deg_std` in
    degrees; `TCO [B, 4, 4]`, normals `[B, 3]`."""
    euler_std = torch.tensor(euler_deg_std, dtype=TCO.dtype, device=TCO.device) * (torch.pi / 180.0)
    R_noise = rotmat_from_euler_sxyz(euler_normals * euler_std)
    t_noise = trans_normals * torch.tensor(trans_std, dtype=TCO.dtype, device=TCO.device)
    return make_se3(TCO[..., :3, :3] @ R_noise, TCO[..., :3, 3] + t_noise)
