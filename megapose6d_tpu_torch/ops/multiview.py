"""Per-view camera poses for multi-view render-and-compare.

Counterpart of `megapose6d_tpu/ops/multiview.py`: camera 0 sits at
`TCO^-1`; each view offset (Panda3D local axes, in units of |tCR|) is
expressed in a frame pointing at the reference point R, and the view
camera looks at R with camera 0's up direction.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .camera import look_at_R
from .se3 import invert_se3, make_se3, rotmat_from_euler_sxyz

Tensor = torch.Tensor

_OFFSETS_PANDA: dict[str, np.ndarray] = {
    "front_1view": np.array([[0, 0, 0]], dtype=np.float64),
    "front_3views": np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0]], dtype=np.float64),
    "front_5views": np.array(
        [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1]], dtype=np.float64
    ),
    "sphere_26views": np.array(
        [
            [x, y, z]
            for y in (0, 1, 2)
            for x in (0, -1, 1)
            for z in (0, 1, -1)
            if not (x == 0 and y == 1 and z == 0)
        ],
        dtype=np.float64,
    ),
}

_VIEW_SETS = {
    "TCO+front_1view": "front_1view",
    "TCO+front_3views": "front_3views",
    "TCO+front_5views": "front_5views",
    "sphere_26views": "sphere_26views",
}


@functools.lru_cache(maxsize=None)
def _offsets_cv(name: str, device: torch.device) -> Tensor:
    """Panda3D (x right, y forward, z up) -> CV axes (x, -z, y). Copied to
    the device once, so a CUDA graph's capture finds it there."""
    o = _OFFSETS_PANDA[name]
    with torch.inference_mode(False):  # an ordinary tensor, usable under autograd too
        return torch.as_tensor(
            np.stack([o[:, 0], -o[:, 2], o[:, 1]], -1), dtype=torch.float32, device=device
        )


def views_tco_pos_sphere(TCO: Tensor, tCR: Tensor, offsets_cv: Tensor) -> Tensor:
    """Per-view camera pose in camera-0 frame, `[B, V, 4, 4]`."""
    TWC0 = invert_se3(TCO)
    R0 = TWC0[..., :3, :3]
    pos0 = TWC0[..., :3, 3]
    tWR = torch.einsum("...ij,...j->...i", R0, tCR) + pos0
    radius = torch.linalg.norm(tCR, dim=-1, keepdim=True)
    up_hint = -R0[..., :, 1]

    Rp = look_at_R(pos0, tWR, up_hint)
    pos_v = pos0[..., None, :] + torch.einsum(
        "...ij,vj->...vi", Rp, offsets_cv
    ) * radius[..., None, :]
    Rv = look_at_R(pos_v, tWR[..., None, :], up_hint[..., None, :])
    TWCv = make_se3(Rv, pos_v)
    return invert_se3(TWC0)[..., None, :, :] @ TWCv


def make_TCO_multiview(
    TCO: Tensor,
    tCR: Tensor,
    multiview_type: str = "TCO+front_3views",
    n_views: int = 4,
    remove_TCO_rendering: bool = False,
    views_inplane_rotations: bool = False,
) -> Tensor:
    """Per-view object poses `TCV_O [B, V, 4, 4]`; view 0 is the raw TCO
    unless `remove_TCO_rendering`."""
    eye = torch.eye(4, dtype=TCO.dtype, device=TCO.device).expand(TCO.shape)
    if n_views == 1:
        TC0_CV = eye[:, None]
    else:
        offsets = _offsets_cv(_VIEW_SETS[multiview_type], TCO.device)
        views = views_tco_pos_sphere(TCO, tCR, offsets)
        TC0_CV = views if remove_TCO_rendering else torch.cat([eye[:, None], views], 1)

    TCV_O = invert_se3(TC0_CV) @ TCO[:, None]

    if views_inplane_rotations:
        angles = torch.tensor(
            [0.0, math.pi / 2, math.pi, 3 * math.pi / 2], dtype=TCO.dtype, device=TCO.device
        )
        zeros = torch.zeros_like(angles)
        dR = rotmat_from_euler_sxyz(torch.stack([zeros, zeros, angles], -1))
        R = dR[None, None] @ TCV_O[:, :, None, :3, :3]
        t = TCV_O[:, :, None, :3, 3].expand(R.shape[:-2] + (3,))
        TCV_O = make_se3(R, t).reshape(TCV_O.shape[0], -1, 4, 4)
    return TCV_O
