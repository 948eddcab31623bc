"""Deterministic near-uniform SO(3) grids (Super-Fibonacci, Alexa 2022).

Counterpart of `megapose6d_tpu/ops/so3_grid.py` (the prune table waits
for the hierarchical coarse mode).
"""

from __future__ import annotations

import math

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
