"""Depth-based pose refinement, the RGB-D pipeline's last stage.

Counterpart of `megapose6d_tpu/inference/depth_refiner.py`. Each refiner
renders the predicted poses' depth at half the image's resolution through
the tiled rasterizer (its visibility pass is the CUDA kernel on the GPU),
then aligns the render with the measured depth:
  - `ICPRefiner`: point-to-plane ICP (`ops/icp.py`);
  - `GNCRegistrationRefiner`: GNC-TLS registration of pixel-wise paired
    points (`ops/registration.py`).
A prediction keeps its RGB pose where the solve fails or is not finite.
Points are chosen with uniform fields from keys split off `PRNGKey(0)`,
as in the JAX package, so both choose the same pixels.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from ..data.tensor_collection import TensorCollection
from ..meshes.mesh_db import BatchedMeshes
from ..ops import icp, rasterizer_tiled, registration
from ..ops._precision import pin_f32
from ..utils import threefry

Tensor = torch.Tensor


def compute_masks(
    mask_type: str,
    depth_rendered: Tensor,
    depth_measured: Tensor,
    depth_delta_thresh: float = 0.1,
) -> Tensor:
    """Object masks for depth refinement: 'simple' is the rendered
    footprint; 'threshold' also rejects pixels whose measured depth is
    missing or more than `depth_delta_thresh` from the render."""
    rendered_ok = depth_rendered > 0
    if mask_type == "simple":
        return rendered_ok
    if mask_type == "threshold":
        delta = (depth_measured - depth_rendered).abs()
        return rendered_ok & (depth_measured > 0) & (delta < depth_delta_thresh)
    raise ValueError(mask_type)


class DepthRefiner(abc.ABC):
    """Refines pose estimates with the observation's depth."""

    def __init__(self, mesh_db: BatchedMeshes, resolution_downscale: int = 2):
        self.mesh_db = mesh_db
        self.downscale = resolution_downscale

    @abc.abstractmethod
    def _refine_batch(
        self, key: np.ndarray, TCO: Tensor, depth_r: Tensor, depth: Tensor, K: Tensor
    ) -> tuple[Tensor, dict[str, Tensor]]:
        """(refined poses `[N, 4, 4]`, extra) from the renders `depth_r
        [N, h, w]` of the poses `TCO`, the measured `depth [h, w]` and `K`."""

    def render_depth(self, TCO: Tensor, mesh_idx: Tensor, K: Tensor, resolution: tuple[int, int]) -> Tensor:
        """Depth renders `[N, h, w]` of the meshes `mesh_idx` at `TCO`."""
        meshes = self.mesh_db.select(mesh_idx)
        out = rasterizer_tiled.render_meshes_tiled(
            meshes.vertices, meshes.normals, meshes.colors, meshes.faces, meshes.face_valid,
            TCO, K.expand(TCO.shape[0], 3, 3), resolution,
        )
        return out.depth

    def refine_poses(
        self,
        predictions: TensorCollection,
        masks=None,
        depth: Tensor | None = None,
        K: Tensor | None = None,
    ) -> tuple[TensorCollection, dict[str, Tensor]]:
        """`predictions.poses [N, 4, 4]`; `depth [H, W]` or `[1, H, W]`
        in metres; `K [3, 3]` or `[1, 3, 3]`; `masks` is not read (the
        refiners mask by the rendered depth, as the JAX package's do, which
        ignore it too). Works on the mesh database's
        device. Returns the predictions with refined poses, and per
        prediction `valid` (and the refiner's own extra)."""
        if depth is None or K is None:
            raise ValueError("depth refinement needs the depth image and K")
        pin_f32()
        dev = self.mesh_db.device
        depth = torch.as_tensor(depth, dtype=torch.float32).to(dev)
        K = torch.as_tensor(K, dtype=torch.float32).to(dev)
        if depth.ndim == 3:
            depth = depth[0]
        if K.ndim == 3:
            K = K[0]
        ds = self.downscale
        if ds > 1:
            depth = depth[::ds, ::ds].contiguous()
            K = K.clone()
            K[:2] /= ds
        TCO = predictions.poses.to(dev, torch.float32)
        mesh_idx = self.mesh_db.label_to_index(predictions.labels)
        depth_r = self.render_depth(TCO, mesh_idx, K, tuple(depth.shape))
        TCO_refined, extra = self._refine_batch(threefry.PRNGKey(0), TCO, depth_r, depth, K)
        out = TensorCollection(infos=dict(predictions.infos), poses=TCO_refined)
        return out, extra


def _keep_failed(TCO: Tensor, TCO_refined: Tensor, valid: Tensor) -> tuple[Tensor, Tensor]:
    """The RGB pose wherever the solve failed or is not finite."""
    ok = valid & torch.isfinite(TCO_refined).all(-1).all(-1)
    return torch.where(ok[:, None, None], TCO_refined, TCO), ok


class ICPRefiner(DepthRefiner):
    """Point-to-plane ICP of the rendered surface onto the measured depth."""

    def __init__(
        self,
        mesh_db: BatchedMeshes,
        n_points: int = 1024,
        n_iterations: int = 30,
        resolution_downscale: int = 2,
    ):
        super().__init__(mesh_db, resolution_downscale)
        self.n_points = n_points
        self.n_iterations = n_iterations

    def _refine_batch(self, key, TCO, depth_r, depth, K):
        keys = threefry.split(key, TCO.shape[0])
        res = icp.icp_refine_pose(keys, TCO, depth, depth_r, K, n_points=self.n_points,
                                  n_iterations=self.n_iterations)
        TCO_refined, ok = _keep_failed(TCO, res.T_delta @ TCO, res.valid)
        return TCO_refined, {"residual": res.residual, "valid": ok}


class GNCRegistrationRefiner(DepthRefiner):
    """GNC-TLS registration of pixel-wise paired clouds: the render of the
    predicted pose and the measured depth over the same pixels."""

    def __init__(
        self,
        mesh_db: BatchedMeshes,
        n_points: int = 512,
        n_iterations: int = 20,
        noise_bound: float = 0.01,
        resolution_downscale: int = 2,
    ):
        super().__init__(mesh_db, resolution_downscale)
        self.n_points = n_points
        self.n_iterations = n_iterations
        self.noise_bound = noise_bound

    def _refine_batch(self, key, TCO, depth_r, depth, K):
        N, H, W = depth_r.shape
        keys = threefry.split(key, N)
        mask = (depth_r > 0) & (depth > 0)
        idx, valid = icp._masked_sample_idx(icp.uniform_fields(keys, (H, W), depth.device), mask, self.n_points)
        src = icp._gather_rows(icp.depth_to_xyz(depth_r, K).reshape(N, H * W, 3), idx)
        tgt = icp.depth_to_xyz(depth, K).reshape(H * W, 3)[idx]
        res = registration.gnc_tls_registration(src, tgt, valid, noise_bound=self.noise_bound,
                                                n_iterations=self.n_iterations)
        TCO_refined, ok = _keep_failed(TCO, res.T_tgt_src @ TCO, res.valid)
        return TCO_refined, {"n_inliers": res.n_inliers, "valid": ok}
