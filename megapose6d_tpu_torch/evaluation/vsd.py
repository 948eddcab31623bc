"""Visible Surface Discrepancy (VSD), with distance maps from the port's
renderer.

Counterpart of `megapose6d_tpu/evaluation/vsd.py`. The distance maps of
the estimated and ground-truth poses come from `render_meshes_tiled`, so
on the GPU their visibility pass is the CUDA kernel (one launch per map
batch, B = the frame's matched instances).

Definition (bop_toolkit `pose_error.vsd`, BOP19 settings):
  - distance maps of the object at the estimated and ground-truth poses;
  - visibility masks: object pixels whose distance is within `delta`
    (15 mm) in front of the measured scene distance, or where the
    measured depth is missing;
  - e_VSD(tau) = the share of the union of the two masks where a pixel is
    not in both or its two distances differ by more than tau;
  - recall = the share of estimates with e_VSD < theta, averaged over
    theta in {0.05..0.5} and tau in {5%..50%} of the object diameter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rasterizer_tiled

Tensor = torch.Tensor

BOP19_VSD_DELTA = 0.015  # meters
BOP19_VSD_TAUS = tuple(np.arange(0.05, 0.51, 0.05))  # x diameter
BOP19_THRESHOLDS = tuple(np.arange(0.05, 0.51, 0.05))


def _ray_norm(K: Tensor, H: int, W: int) -> Tensor:
    """|K^-1 (u, v, 1)| per pixel, `[..., H, W]` for `K [..., 3, 3]`."""
    u = torch.arange(W, dtype=torch.float32, device=K.device)
    v = torch.arange(H, dtype=torch.float32, device=K.device)[:, None]
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    return torch.sqrt(1.0 + ((u - cx) / fx) ** 2 + ((v - cy) / fy) ** 2)


def render_distance_maps(meshes, TCO: Tensor, K: Tensor, resolution: tuple[int, int]) -> Tensor:
    """Euclidean distance maps `[N, H, W]` (0 where nothing is hit) of
    `meshes` (selected, leading dim N) at `TCO [N, 4, 4]`, `K [N, 3, 3]`."""
    out = rasterizer_tiled.render_meshes_tiled(
        meshes.vertices, meshes.normals, meshes.colors, meshes.faces, meshes.face_valid,
        TCO, K, tuple(resolution),
    )
    return out.depth * _ray_norm(K, *resolution)


def depth_to_distance(depth: Tensor, K: Tensor) -> Tensor:
    """Measured z-depth `[H, W]` -> distance `[H, W]`, for `K [3, 3]`."""
    return depth * _ray_norm(K, *depth.shape)


def compute_vsd(
    depth_measured,  # [H, W] meters (z-depth)
    TCO_pred,  # [N, 4, 4]
    TCO_gt,  # [N, 4, 4]
    K,  # [3, 3]
    meshes,  # selected BatchedMeshes, leading dim N
    diameters,  # [N]
    taus=BOP19_VSD_TAUS,
    delta: float = BOP19_VSD_DELTA,
) -> np.ndarray:
    """e_VSD per estimate per tau, `[N, n_taus]`, computed on the meshes'
    device."""
    dev = meshes.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    TCO_pred, TCO_gt, K, diameters = f32(TCO_pred), f32(TCO_gt), f32(K), f32(diameters)
    depth = f32(depth_measured)
    N = TCO_pred.shape[0]
    K_b = K.expand(N, 3, 3)
    dist_est = render_distance_maps(meshes, TCO_pred, K_b, tuple(depth.shape))
    dist_gt = render_distance_maps(meshes, TCO_gt, K_b, tuple(depth.shape))
    dist_meas = depth_to_distance(depth, K)[None]  # [1, H, W]

    meas_valid = dist_meas > 0

    def visib(dist_r):
        return (dist_r > 0) & ((dist_r < dist_meas + delta) | ~meas_valid)

    v_est, v_gt = visib(dist_est), visib(dist_gt)
    union, both = v_est | v_gt, v_est & v_gt
    d_diff = (dist_est - dist_gt).abs()
    n_union_raw = union.sum(dim=(1, 2))
    n_union = n_union_raw.clamp_min(1)
    errs = []
    for tau in taus:
        tau_n = torch.tensor(tau, dtype=torch.float32, device=dev) * diameters[:, None, None]
        bad = union & (~both | (d_diff > tau_n))
        e = bad.sum(dim=(1, 2)).float() / n_union.float()
        errs.append(torch.where(n_union_raw == 0, 1.0, e))  # nothing visible: error 1
    return torch.stack(errs, dim=-1).cpu().numpy()


def vsd_recall(e_vsd: np.ndarray, thresholds=BOP19_THRESHOLDS) -> float:
    """AR_VSD: the mean over the (tau, theta) grid of 1[e_VSD(tau) < theta]."""
    e = np.asarray(e_vsd)  # [N, n_taus]
    return float(np.mean([(e < th).mean() for th in thresholds]))
