"""Robust rigid registration of paired point sets (GNC-TLS), the weighted
Kabsch step, and farthest-point sampling.

Counterpart of `megapose6d_tpu/ops/registration.py`: graduated
non-convexity over a truncated-least-squares cost around a weighted
Kabsch step, a fixed number of annealing steps. The JAX functions take
one point set and are `vmap`ped; `kabsch` and `gnc_tls_registration` here
take a leading batch dimension (one entry per object), and the 3x3 SVDs
of a step run as one batched call on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import threefry

Tensor = torch.Tensor


def sample_farthest_points(
    points: Tensor,  # [N, 3]
    k: int,
    valid: Tensor | None = None,  # [N] bool
    key: np.ndarray | None = None,  # uint32 [2]: a random first point
) -> Tensor:
    """Indices `[k]` of a greedy max-min (farthest-point) subsample,
    starting from the first valid point, or from the valid point of
    highest `uniform(key, (N,))` when `key` is given."""
    N = points.shape[0]
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=points.device)
    big = torch.tensor(1e30, dtype=points.dtype, device=points.device)
    if key is not None:
        u = torch.from_numpy(threefry.uniform(key, (N,))).to(points.device)
        first = torch.where(valid, u, -1.0).argmax()
    else:
        first = valid.to(torch.uint8).argmax()
    dists = torch.where(valid, ((points - points[first]) ** 2).sum(-1), -big)
    idx = [first]
    for _ in range(k - 1):
        nxt = dists.argmax()
        d_new = ((points - points[nxt]) ** 2).sum(-1)
        dists = torch.minimum(dists, torch.where(valid, d_new, -big))
        idx.append(nxt)
    return torch.stack(idx)


def kabsch(src: Tensor, tgt: Tensor, weights: Tensor) -> Tensor:
    """Weighted closed-form rigid alignment `T [B, 4, 4]` with
    `T @ src ~= tgt`, for `src, tgt [B, N, 3]`, `weights [B, N]`."""
    w = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    mu_s = (src * w[..., None]).sum(1)
    mu_t = (tgt * w[..., None]).sum(1)
    S = (src - mu_s[:, None]).transpose(1, 2) @ ((tgt - mu_t[:, None]) * w[..., None])  # [B, 3, 3]
    U, _, Vt = torch.linalg.svd(S)
    V, Ut = Vt.transpose(1, 2), U.transpose(1, 2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = V @ D @ Ut
    t = mu_t - (R @ mu_s[..., None])[..., 0]
    T = torch.eye(4, dtype=src.dtype, device=src.device).repeat(src.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T


class RegistrationResult(NamedTuple):
    T_tgt_src: Tensor  # [B, 4, 4]
    inliers: Tensor  # [B, N] bool (final residual within the noise bound)
    n_inliers: Tensor  # [B] int32
    valid: Tensor  # [B] bool (enough valid correspondences, finite)


def _residual2(src: Tensor, tgt: Tensor, T: Tensor) -> Tensor:
    return ((src @ T[:, :3, :3].transpose(1, 2) + T[:, None, :3, 3] - tgt) ** 2).sum(-1)


def gnc_tls_registration(
    src: Tensor,  # [B, N, 3]
    tgt: Tensor,  # [B, N, 3]
    valid: Tensor,  # [B, N] bool putative correspondences
    noise_bound: float = 0.01,
    n_iterations: int = 20,
    gnc_factor: float = 1.4,
    min_points: int = 6,
) -> RegistrationResult:
    """GNC-TLS rigid registration over given correspondences: alternate a
    weighted Kabsch step with the TLS closed-form weights while annealing
    mu by `gnc_factor`."""
    c2 = torch.tensor(noise_bound, dtype=torch.float32) ** 2
    c2 = c2.to(src.device)
    # Invalid slots may hold NaN; zero them before any weighted sum.
    valid = valid & torch.isfinite(src).all(-1) & torch.isfinite(tgt).all(-1)
    src = torch.where(valid[..., None], src, 0.0)
    tgt = torch.where(valid[..., None], tgt, 0.0)
    w0 = valid.to(torch.float32)
    n_valid = w0.sum(-1)

    T = kabsch(src, tgt, w0 + 1e-9)
    r2_max = torch.where(valid, _residual2(src, tgt, T), 0.0).amax(-1)
    mu = (c2 / (2.0 * r2_max - c2).clamp_min(1e-9)).clamp_min(1e-4)  # [B]
    for _ in range(n_iterations):
        r2 = _residual2(src, tgt, T)
        m = mu[:, None]
        lo = (m / (m + 1.0)) * c2
        hi = ((m + 1.0) / m) * c2
        w_mid = torch.sqrt(c2 * m * (m + 1.0) / r2.clamp_min(1e-12)) - m
        w = torch.where(r2 <= lo, 1.0, torch.where(r2 >= hi, 0.0, w_mid))
        w = w.clamp(0.0, 1.0) * w0
        T = kabsch(src, tgt, w + 1e-9)
        mu = mu * gnc_factor

    inliers = valid & (_residual2(src, tgt, T) <= c2)
    ok = (n_valid >= min_points) & torch.isfinite(T).all(-1).all(-1)
    T = torch.where(ok[:, None, None], T, torch.eye(4, dtype=T.dtype, device=T.device))
    return RegistrationResult(T_tgt_src=T, inliers=inliers,
                              n_inliers=inliers.sum(-1).to(torch.int32), valid=ok)
