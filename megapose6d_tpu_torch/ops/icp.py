"""Point-to-plane ICP on depth images.

Counterpart of `megapose6d_tpu/ops/icp.py`: XYZ and normal maps from
depth, stratified sampling of masked pixels, centroid pre-alignment, then
a fixed number of point-to-plane Gauss-Newton steps with nearest-neighbour
correspondences recomputed each step and a 6x6 solve. The JAX functions
take one object and are `vmap`ped; here a leading batch dimension (one
entry per object) is written out. The random choice of pixels uses the
same uniform fields as the JAX package (`utils/threefry.py`), drawn on
the host from the same keys and copied to the device, so both packages
sample the same points.

Precision: f32 throughout with TF32 off (`pin_f32`); squared distances
are the explicit `sum((p - q) ** 2)` as in the JAX package (the matmul
form of `torch.cdist` rounds otherwise and flips `argmin`s); `argmin` and
`argmax` take the first index on ties, as XLA's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import threefry
from .se3 import make_se3

Tensor = torch.Tensor


def depth_to_xyz(depth: Tensor, K: Tensor) -> Tensor:
    """Back-project depth `[..., H, W]` with `K [..., 3, 3]` (batch dims
    broadcast) -> `[..., H, W, 3]`."""
    H, W = depth.shape[-2:]
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    return torch.stack([x, y, depth.expand_as(x)], dim=-1)


def depth_normals(depth: Tensor, K: Tensor) -> Tensor:
    """Normals `[..., H, W, 3]` from central differences of the XYZ map,
    wrapping around the image borders (`roll`), oriented to the camera."""
    xyz = depth_to_xyz(depth, K)
    dx = torch.roll(xyz, -1, dims=-2) - torch.roll(xyz, 1, dims=-2)
    dy = torch.roll(xyz, -1, dims=-3) - torch.roll(xyz, 1, dims=-3)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.sqrt((n * n).sum(-1, keepdim=True))
    n = n / norm.clamp_min(1e-9)
    flip = torch.where(n[..., 2:3] > 0, -1.0, 1.0)
    return n * flip


def uniform_fields(keys: np.ndarray, shape: tuple[int, int], device) -> Tensor:
    """`jax.random.uniform(key, shape)` for each key of `keys [B, 2]`,
    drawn on the host -> `[B, *shape]` float32 on `device`."""
    u = np.stack([threefry.uniform(k, tuple(shape)) for k in np.asarray(keys, np.uint32)])
    return torch.from_numpy(u).to(device)


def _masked_sample_idx(u: Tensor, mask: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """`n` flat indices of masked pixels per image, and each slot's
    validity. `u [..., H, W]` is the image's uniform field, `mask` its
    pixels to choose from.

    Stratified lattice sampling: slot (a, b) of an sh x sw grid takes the
    pixel of highest `u + mask` on the lattice {y = a mod sh, x = b mod sw}
    (the first on ties); it is valid when that pixel is masked."""
    H, W = mask.shape[-2:]
    lead = mask.shape[:-2]
    sh = max(1, int(n**0.5))
    while n % sh:
        sh -= 1
    sw = n // sh
    Hp, Wp = -(-H // sh) * sh, -(-W // sw) * sw
    scores = u + mask.to(torch.float32)
    scores = torch.nn.functional.pad(scores, (0, Wp - W, 0, Hp - H), value=-1.0)
    gh, gw = Hp // sh, Wp // sw
    nl = len(lead)
    cells = scores.reshape(lead + (gh, sh, gw, sw)).permute(*range(nl), nl + 1, nl + 3, nl, nl + 2)
    cells = cells.reshape(lead + (n, gh * gw))  # [..., (sh, sw), (gh, gw)]
    best = cells.argmax(dim=-1)
    valid = torch.gather(cells, -1, best[..., None])[..., 0] >= 1.0
    yblk, xblk = best // gw, best % gw
    slot = torch.arange(n, device=best.device)
    y = torch.clamp_max(yblk * sh + slot // sw, H - 1)
    x = torch.clamp_max(xblk * sw + slot % sw, W - 1)
    return y * W + x, valid


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """`x [B, M, C]`, `idx [B, N]` -> `[B, N, C]`."""
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + x.shape[-1:]))


def _so3_exp(w: Tensor) -> Tensor:
    """Rodrigues' exponential map, `w [B, 3]` -> `[B, 3, 3]`."""
    theta = torch.sqrt((w * w).sum(-1))
    k = w / theta.clamp_min(1e-12)[:, None]
    z = torch.zeros_like(theta)
    Kx = torch.stack([
        torch.stack([z, -k[:, 2], k[:, 1]], -1),
        torch.stack([k[:, 2], z, -k[:, 0]], -1),
        torch.stack([-k[:, 1], k[:, 0], z], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    s, c = torch.sin(theta)[:, None, None], torch.cos(theta)[:, None, None]
    R = eye + s * Kx + (1.0 - c) * (Kx @ Kx)
    return torch.where((theta < 1e-9)[:, None, None], eye, R)


class ICPResult(NamedTuple):
    T_delta: Tensor  # [B, 4, 4] correction, applied on the left
    residual: Tensor  # [B] mean |point-to-plane| of the inliers at the last step
    valid: Tensor  # [B] bool


def icp_point_to_plane(
    src_pts: Tensor,  # [B, N, 3] source points (rendered surface), camera frame
    tgt_pts: Tensor,  # [B, M, 3] target points (measured depth)
    tgt_normals: Tensor,  # [B, M, 3]
    src_valid: Tensor,  # [B, N] bool
    tgt_valid: Tensor,  # [B, M] bool
    n_iterations: int = 30,
    max_corr_dist: float = 0.02,
    damping: float = 1e-6,
) -> ICPResult:
    """Fixed-iteration point-to-plane ICP per batch entry: the SE(3)
    correction minimising sum |n_tgt . (T p_src - p_tgt_nn)|^2."""
    B = src_pts.shape[0]
    dt, dev = src_pts.dtype, src_pts.device
    tgt_safe = torch.where(tgt_valid[..., None], tgt_pts, torch.tensor(1e9, dtype=dt, device=dev))
    eye6 = damping * torch.eye(6, dtype=dt, device=dev)
    T = torch.eye(4, dtype=dt, device=dev).expand(B, 4, 4)
    res = torch.zeros(B, dtype=dt, device=dev)
    for _ in range(n_iterations):
        p = src_pts @ T[:, :3, :3].transpose(1, 2) + T[:, None, :3, 3]
        d2 = ((p[:, :, None, :] - tgt_safe[:, None, :, :]) ** 2).sum(-1)  # [B, N, M]
        nn = d2.argmin(dim=-1)
        nn_d2 = torch.gather(d2, -1, nn[..., None])[..., 0]
        q, n = _gather_rows(tgt_pts, nn), _gather_rows(tgt_normals, nn)
        r = (n * (p - q)).sum(-1)  # [B, N]
        # Normals are NaN at depth discontinuities; a NaN row would poison
        # J^T r through 0 * NaN.
        w_bool = (src_valid & (nn_d2 < max_corr_dist**2) & torch.isfinite(r)
                  & torch.isfinite(n).all(-1))
        w = w_bool.to(dt)
        r = torch.where(w_bool, r, 0.0)
        J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)  # [B, N, 6]
        J = torch.where(w_bool[..., None], J, 0.0)
        Jw = (J * w[..., None]).transpose(1, 2)
        A = Jw @ J + eye6
        b = -(Jw @ r[..., None])
        xi = torch.linalg.solve_ex(A, b)[0][..., 0]  # [B, 6] (omega, v)
        T = make_se3(_so3_exp(xi[:, :3]), xi[:, 3:]) @ T
        res = (r.abs() * w).sum(-1) / w.sum(-1).clamp_min(1.0)
    ok = (src_valid.sum(-1) > 10) & (tgt_valid.sum(-1) > 10) & torch.isfinite(T).all(-1).all(-1)
    eye4 = torch.eye(4, dtype=dt, device=dev)
    return ICPResult(T_delta=torch.where(ok[:, None, None], T, eye4), residual=res, valid=ok)


def icp_refine_pose(
    key: np.ndarray,  # [B, 2] uint32, one threefry key per object
    TCO_pred: Tensor | None,  # [B, 4, 4], not read
    depth_measured: Tensor,  # [H, W] metres
    depth_rendered: Tensor,  # [B, H, W] metres, renders of the predictions
    K: Tensor,  # [3, 3]
    mask: Tensor | None = None,  # [H, W] or [B, H, W] bool, extra mask on the measured depth
    n_points: int = 1024,
    n_iterations: int = 30,
    depth_range: tuple[float, float] = (0.2, 5.0),
) -> ICPResult:
    """Refine each prediction: sample measured and rendered surface points,
    shift the rendered ones onto the measured centroid, then point-to-plane
    ICP. The returned `T_delta` includes the shift; apply it as
    `TCO_refined = T_delta @ TCO_pred`. The JAX package's function on one
    object, batched over the objects (its `vmap`): `key` holds each
    object's key, and `TCO_pred` is not read there either."""
    B, H, W = depth_rendered.shape
    dev = depth_rendered.device
    xyz_tgt = depth_to_xyz(depth_measured, K).reshape(-1, 3)
    nrm_tgt = depth_normals(depth_measured, K).reshape(-1, 3)
    xyz_src = depth_to_xyz(depth_rendered, K)  # [B, H, W, 3]

    # Measured points only where the render is valid too.
    tgt_ok = (depth_measured > depth_range[0]) & (depth_measured < depth_range[1])
    if mask is not None:
        tgt_ok = tgt_ok & mask
    tgt_ok = tgt_ok & (depth_rendered > 0)
    src_ok = (depth_rendered > 0) & torch.isfinite(xyz_src).all(-1)

    k12 = np.stack([threefry.split(k) for k in np.asarray(key, np.uint32)])  # [B, 2, 2]
    u1 = uniform_fields(k12[:, 0], (H, W), dev)
    u2 = uniform_fields(k12[:, 1], (H, W), dev)
    src_idx, src_valid = _masked_sample_idx(u1, src_ok, n_points)
    src = _gather_rows(xyz_src.reshape(B, H * W, 3), src_idx)
    ok1 = src_ok.sum((-2, -1)) >= 1
    tgt_idx, tgt_valid = _masked_sample_idx(u2, tgt_ok, n_points)
    tgt, tgt_nrm = xyz_tgt[tgt_idx], nrm_tgt[tgt_idx]

    w_src = src_valid.to(src.dtype)[..., None]
    w_tgt = tgt_valid.to(src.dtype)[..., None]
    c_src = (src * w_src).sum(1) / w_src.sum(1).clamp_min(1.0)
    c_tgt = (tgt * w_tgt).sum(1) / w_tgt.sum(1).clamp_min(1.0)
    shift = c_tgt - c_src  # [B, 3]

    result = icp_point_to_plane(src + shift[:, None], tgt, tgt_nrm, src_valid, tgt_valid,
                                n_iterations=n_iterations)
    eye4 = torch.eye(4, dtype=src.dtype, device=dev)
    T_shift = eye4.repeat(B, 1, 1)
    T_shift[:, :3, 3] = shift
    ok = result.valid & ok1
    T_delta = torch.where(ok[:, None, None], result.T_delta @ T_shift, eye4)
    return ICPResult(T_delta=T_delta, residual=result.residual, valid=ok)
