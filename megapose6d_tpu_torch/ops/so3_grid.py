"""Deterministic near-uniform SO(3) grids (Super-Fibonacci, Alexa 2022).

Counterpart of `megapose6d_tpu/ops/so3_grid.py`: the grid and the prune
table of the hierarchical coarse mode.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .se3 import rotmat_from_quat

# phi = sqrt(2); psi is the real root of x^4 = x + 4.
_PHI = math.sqrt(2.0)
_PSI = 1.533751168755204288118041


def super_fibonacci_quats(n: int, dtype=np.float64) -> np.ndarray:
    """`n` near-uniform unit quaternions `[n, 4]` (xyzw), deterministic."""
    s = np.arange(n, dtype=np.float64) + 0.5
    t = s / n
    d = 2.0 * np.pi * s
    r = np.sqrt(t)
    big_r = np.sqrt(1.0 - t)
    alpha = d / _PHI
    beta = d / _PSI
    w = r * np.sin(alpha)
    x = r * np.cos(alpha)
    y = big_r * np.sin(beta)
    z = big_r * np.cos(beta)
    return np.stack([x, y, z, w], axis=-1).astype(dtype)


def make_so3_grid(resolution: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """Rotation-matrix grid `[resolution, 3, 3]` f32 on `device`."""
    quats = torch.as_tensor(
        super_fibonacci_quats(resolution), dtype=torch.float32, device=device
    )
    return rotmat_from_quat(quats)


def load_qua_grid(path: str | Path, device: str | torch.device = "cuda") -> torch.Tensor:
    """A LaValle-format `.qua` file (whitespace-separated xyzw lines, the
    reference's grids) as rotation matrices `[N, 3, 3]` float32."""
    xyzw = np.loadtxt(str(path), dtype=np.float64, ndmin=2)
    if xyzw.shape[1] != 4:
        raise ValueError(f"{path}: expected lines of 4 numbers (x y z w), got {xyzw.shape}")
    return rotmat_from_quat(torch.as_tensor(xyzw, dtype=torch.float32, device=device))


def build_prune_table(grid, parent_grid, max_children: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Voronoi assignment of `grid [M, 3, 3]` to its nearest rotation of
    `parent_grid [M1, 3, 3]` (largest trace of `R P^T`, in float64), as
    padded per-parent child lists: children `[M1, C]` int32 (indices into
    `grid`, padded with index 0) and valid `[M1, C]` bool. C is the largest
    parent's count of children, or `max_children` (a parent's first C kept).

    The hierarchical coarse stage scores the parent grid first, then only
    the children of the best parents; `grid` stays the hypothesis
    vocabulary."""
    R = np.asarray(torch.as_tensor(grid).cpu(), np.float64)
    P = np.asarray(torch.as_tensor(parent_grid).cpu(), np.float64)
    parent_of = np.einsum("mij,pij->mp", R, P).argmax(axis=1)  # [M]
    M1 = P.shape[0]
    C = int(np.bincount(parent_of, minlength=M1).max()) if max_children is None else int(max_children)
    children = np.zeros((M1, C), np.int32)
    valid = np.zeros((M1, C), bool)
    for p in range(M1):
        ids = np.nonzero(parent_of == p)[0][:C]
        children[p, : len(ids)] = ids
        valid[p, : len(ids)] = True
    return children, valid
