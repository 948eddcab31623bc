"""Mesh point-set ops: axis-aligned bounds, their centre and corners,
point subsampling.

Counterpart of `megapose6d_tpu/ops/mesh_ops.py`. `sample_points`' random
mode takes a JAX-layout key (`uint32 [2]`, as `utils.threefry` makes) and
draws the JAX package's uniform scores with `utils.threefry.uniform`, so
its samples equal the JAX package's for the same key.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import threefry

Tensor = torch.Tensor

# The 8 corner sign patterns of an axis-aligned box, x slowest.
_CORNER_SIGNS = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]


def masked_bounds(points: Tensor, valid: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """(min, max) `[..., 3]` over the point axis of `points [..., N, 3]`;
    points where `valid [..., N]` is False are left out."""
    if valid is None:
        return points.amin(dim=-2), points.amax(dim=-2)
    big = torch.finfo(points.dtype).max
    v = valid[..., None]
    return (torch.where(v, points, big).amin(dim=-2), torch.where(v, points, -big).amax(dim=-2))


def get_meshes_center(points: Tensor, valid: Tensor | None = None) -> Tensor:
    """The centre `[..., 3]` of the points' axis-aligned box."""
    lo, hi = masked_bounds(points, valid)
    return (lo + hi) / 2


def get_meshes_bounding_boxes(points: Tensor, valid: Tensor | None = None) -> Tensor:
    """The 8 corners `[..., 8, 3]` of the points' axis-aligned box."""
    lo, hi = masked_bounds(points, valid)
    center, half = (lo + hi) / 2, (hi - lo) / 2
    signs = torch.tensor(_CORNER_SIGNS, dtype=points.dtype, device=points.device)
    return center[..., None, :] + signs * half[..., None, :]


def _strided_index(N: int, n: int) -> np.ndarray:
    """`jnp.linspace(0, N - 1, n).astype(int32)` as XLA computes it in
    float32: `i * ((N - 1) * (1 / (n - 1)))` (the division by a constant
    becomes a multiplication by its reciprocal, and the constants fold
    together), the last exactly `N - 1`, truncated."""
    if n <= 1:
        return np.zeros(n, np.int32)
    scale = np.float32(N - 1) * (np.float32(1) / np.float32(n - 1))
    return np.append(np.arange(n - 1, dtype=np.float32) * scale, np.float32(N - 1)).astype(np.int32)


def sample_points(key: np.ndarray | None, points: Tensor, n_points: int, deterministic: bool = False) -> Tensor:
    """`n_points` of the `N` points of each row of `points [B, N, 3]`.

    Deterministic: the evenly strided subset `linspace(0, N - 1, n)`
    truncated, in the JAX package's float32 arithmetic. Random: without
    replacement, the `n_points` largest of uniform scores `[B, N]` drawn from `key` (ties to the lower index, as
    `jax.lax.top_k`)."""
    B, N, _ = points.shape
    if deterministic:
        idx = torch.as_tensor(_strided_index(N, n_points), device=points.device)
        idx = idx.long().expand(B, n_points)
    else:
        scores = torch.as_tensor(threefry.uniform(np.asarray(key, np.uint32), (B, N)), device=points.device)
        idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :n_points]
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))
