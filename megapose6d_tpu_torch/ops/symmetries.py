"""Object symmetry sets (BOP convention), host-side numpy.

Counterpart of the parts of `megapose6d_tpu/ops/symmetries.py` that the
mesh database needs.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ContinuousSymmetry:
    """Rotational symmetry about `axis` through `offset` (must be 0)."""

    offset: np.ndarray = field(default_factory=lambda: np.zeros(3))
    axis: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))


@dataclass
class DiscreteSymmetry:
    """A single symmetry pose, `(4, 4)` homogeneous matrix."""

    pose: np.ndarray = field(default_factory=lambda: np.eye(4))


def _euler_sxyz_mat(euler: np.ndarray) -> np.ndarray:
    ax, ay, az = euler
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def make_symmetries_poses(
    symmetries_discrete: list[DiscreteSymmetry] = (),
    symmetries_continuous: list[ContinuousSymmetry] = (),
    n_symmetries_continuous: int = 8,
    units: str = "mm",
    scale: float | None = None,
) -> np.ndarray:
    """All symmetry transforms {I, discrete} x {continuous samples} as
    `[S, 4, 4]` float64; the identity comes first."""
    if scale is None:
        scale = {"m": 1.0, "mm": 0.001}[units]
    all_discrete = [np.eye(4)]
    for sym_d in symmetries_discrete:
        M = np.array(sym_d.pose, dtype=np.float64).copy()
        M[:3, -1] *= scale
        all_discrete.append(M)
    all_continuous = []
    for sym_c in symmetries_continuous:
        if not np.allclose(sym_c.offset, 0):
            raise ValueError("offset symmetries are not supported")
        axis = np.asarray(sym_c.axis, dtype=np.float64)
        if axis.sum() != 1:
            raise ValueError(f"continuous symmetry axis must be a unit axis: {axis}")
        for n in range(n_symmetries_continuous):
            M = np.eye(4)
            M[:3, :3] = _euler_sxyz_mat(axis * 2 * np.pi * n / n_symmetries_continuous)
            all_continuous.append(M)
    out = [Mc @ Md for Md in all_discrete for Mc in all_continuous] if all_continuous else all_discrete
    return np.stack(out, axis=0)


def pad_symmetries(syms: np.ndarray, n_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad `[S, 4, 4]` to `[n_max, 4, 4]` with identities + validity mask."""
    if len(syms) > n_max:
        warnings.warn(
            f"pad_symmetries: truncating {len(syms)} symmetry poses to n_max={n_max}",
            stacklevel=2,
        )
    s = min(len(syms), n_max)
    out = np.tile(np.eye(4), (n_max, 1, 1))
    out[:s] = syms[:s]
    valid = np.zeros(n_max, dtype=bool)
    valid[:s] = True
    return out, valid
