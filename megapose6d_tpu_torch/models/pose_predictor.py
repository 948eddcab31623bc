"""PosePredictor: the render-and-compare network (coarse + refiner).

Counterpart of `megapose6d_tpu/models/pose_predictor.py`. One module
serves both roles, configured by flags:
  - refiner: `predict_pose_update=True`, V rendered views, 9D pose head
    applied about the reference point;
  - coarse: `predict_rendered_views_logits=True`, 1 view, logits head.
`refine_step` and `score_views` take NHWC tensors and run one
crop -> render -> CNN (-> SE(3) update) pass; the caller loops.
The render goes through the tiled rasterizer, whose visibility pass is
the CUDA kernel on the GPU, or with `renderer="scan"` through the scan
renderer (`ops/rasterizer.py`, plain torch, two-sided). Only the config
picks the renderer, never the device.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from ..meshes.mesh_db import BatchedMeshes
from ..ops import cropping, multiview, rasterizer, rasterizer_tiled
from ..ops.camera import get_K_crop_resize, get_K_resize, masked_boxes_from_uv, project_points_robust
from ..ops.pose_init import pose_update_with_reference_point
from ..ops.se3 import normalize_T, rotmat_from_ortho6d
from .backbones import BatchNorm, Conv, GroupNorm, make_backbone

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PosePredictorConfig:
    """Static model configuration (the JAX package's fields that the
    ported path reads)."""

    backbone: str = "resnet34"
    render_size: tuple[int, int] = (240, 320)
    # Rasterise the rendered views at this (lower) resolution and upsample
    # them bilinearly to `render_size` before the CNN (None: rasterise at
    # `render_size`). The CNN's input, and so its weights, do not change.
    render_at: tuple[int, int] | None = None
    multiview_type: str = "TCO+front_3views"
    views_inplane_rotations: bool = False
    remove_TCO_rendering: bool = False
    predict_pose_update: bool = True
    predict_rendered_views_logits: bool = False
    render_normals: bool = True
    n_rendered_views: int = 1
    input_depth: bool = False
    render_depth: bool = False
    depth_normalization_type: str = "none"
    n_features: int = 512
    compute_dtype: str = "float32"
    crop_lamb: float = 1.4
    mv_crop_points: int = 200
    renderer: str = "tiled"  # "tiled" (the CUDA kernel on the card) | "scan" (plain torch)
    face_chunk: int = 64  # the scan renderer's face chunk
    # The tiled renderer's faces per chunk: `rasterizer_tiled.FACE_CHUNK`,
    # the only value taken. Kept so that configs that carry it load.
    tile_face_chunk: int = rasterizer_tiled.FACE_CHUNK
    # How many hypotheses share one program of the JAX package's Pallas
    # kernel. It changes no pixel there, and has no effect here: the CUDA
    # kernel's blocks are tiles of one image. Read so that run configs
    # that carry it load.
    tile_hyp_pack: int = 1
    backface_cull: bool = True  # meshes from MeshDataBase are winding-normalized
    z_near: float = 0.01

    def __post_init__(self):
        if self.tile_face_chunk != rasterizer_tiled.FACE_CHUNK:
            raise ValueError(f"tile_face_chunk {self.tile_face_chunk}: the tiled renderer takes chunks of "
                             f"{rasterizer_tiled.FACE_CHUNK} faces only")

    @property
    def n_inputs(self) -> int:
        render_c = 3 + 3 * self.render_normals + self.render_depth
        return (3 + self.input_depth) + render_c * self.n_rendered_views


def make_refiner_config(**overrides) -> PosePredictorConfig:
    """Paper refiner: 4 views (TCO+front_3views), normals, 9D head."""
    kw = dict(
        n_rendered_views=4, multiview_type="TCO+front_3views", render_normals=True,
        predict_pose_update=True, predict_rendered_views_logits=False,
    )
    kw.update(overrides)
    return PosePredictorConfig(**kw)


def make_coarse_config(**overrides) -> PosePredictorConfig:
    """Paper coarse model: 1 view, logits head."""
    kw = dict(
        n_rendered_views=1, render_normals=True,
        predict_pose_update=False, predict_rendered_views_logits=True,
    )
    kw.update(overrides)
    return PosePredictorConfig(**kw)


_DEPTH_NORMALIZATIONS = ("tCR_scale", "tCR_scale_clamp_center", "tCR_center_clamp", "none")


def _lecun_normal_(w: Tensor, fan_in: int, scale: float, generator: torch.Generator) -> None:
    """flax's variance-scaling truncated normal (lecun_normal at scale 1)."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class PosePredictor(nn.Module):
    def __init__(self, cfg: PosePredictorConfig):
        super().__init__()
        if cfg.depth_normalization_type not in _DEPTH_NORMALIZATIONS:
            raise ValueError(f"unknown depth_normalization_type: {cfg.depth_normalization_type}")
        self.cfg = cfg
        self.backbone = make_backbone(
            cfg.backbone, cfg.n_inputs, tuple(cfg.render_size), cfg.n_features,
            _DTYPES[cfg.compute_dtype],
        )
        self.pose_fc = nn.Linear(cfg.n_features, 9) if cfg.predict_pose_update else None
        self.views_logits_fc = (
            nn.Linear(cfg.n_features, cfg.n_rendered_views)
            if cfg.predict_rendered_views_logits else None
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PosePredictor":
        """flax's initializers: lecun-normal kernels, zero biases, unit
        GroupNorm and BatchNorm scales (running statistics 0 and 1); the
        pose head starts near the identity update
        (bias = ortho6d identity + vz=1, kernel at variance scale 1e-3)."""
        for m in self.modules():
            if isinstance(m, Conv):
                _lecun_normal_(m.weight, m.weight[0].numel(), 1.0, generator)
            elif isinstance(m, nn.Linear):
                scale = 1e-3 if m is self.pose_fc else 1.0
                _lecun_normal_(m.weight, m.in_features, scale, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (GroupNorm, BatchNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        if self.pose_fc is not None:
            self.pose_fc.bias.copy_(torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1]))
        return self

    def twin(self, **changes) -> "PosePredictor":
        """This model under a configuration with `changes` (`compute_dtype`,
        `render_at`, `renderer`, `face_chunk`, `backface_cull`), sharing its
        parameter tensors: no copy, one `state_dict`. Changes that would
        alter the parameters raise."""
        allowed = {"compute_dtype", "render_at", "renderer", "face_chunk", "backface_cull"}
        if not set(changes) <= allowed:
            raise ValueError(f"a twin may change only {sorted(allowed)}, not {sorted(set(changes) - allowed)}")
        twin = copy.copy(self)  # shares the _parameters, _buffers and _modules dicts
        twin.cfg = dataclasses.replace(self.cfg, **changes)
        return twin

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------

    def net_forward(self, x: Tensor) -> dict[str, Tensor]:
        """Backbone + heads; `x [B, H, W, C]` NHWC."""
        feats = self.backbone(x, _DTYPES[self.cfg.compute_dtype])
        out = {}
        if self.pose_fc is not None:
            out["pose"] = self.pose_fc(feats)
        if self.views_logits_fc is not None:
            out["renderings_logits"] = self.views_logits_fc(feats)
        return out

    def crop_inputs(
        self, images: Tensor, K: Tensor, TCO: Tensor, tCR: Tensor, meshes: BatchedMeshes
    ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        """Crop the observation around the projected hypothesis.
        `images [B or 1, H, W, C]`; returns (crops, K_crop, boxes_rend,
        boxes_crop)."""
        points = meshes.points
        uv = project_points_robust(points, K, TCO)
        boxes_rend = masked_boxes_from_uv(uv, torch.ones(uv.shape[:2], dtype=torch.bool, device=uv.device))
        boxes_crop, images_cropped = cropping.deepim_crops_robust(
            images=images, obs_boxes=boxes_rend, K=K, TCO_pred=TCO, tCR=tCR,
            O_vertices=points, output_size=self.cfg.render_size, lamb=self.cfg.crop_lamb,
            depth_dim=3 if self.cfg.input_depth else None,
        )
        K_crop = get_K_crop_resize(K, boxes_crop, self.cfg.render_size)
        return images_cropped, K_crop, boxes_rend, boxes_crop

    def compute_crops_multiview(
        self, im_hw: tuple[int, int], K: Tensor, TCV_O: Tensor, tCV_R: Tensor,
        meshes: BatchedMeshes,
    ) -> Tensor:
        """Intrinsics of the per-view crop cameras, `[B, V, 3, 3]`."""
        B, V = TCV_O.shape[:2]
        stride = max(1, meshes.points.shape[1] // self.cfg.mv_crop_points)
        pts_mv = meshes.points[:, ::stride].repeat_interleave(V, dim=0)
        K_mv = K.expand(B, 3, 3).repeat_interleave(V, dim=0)
        TCV_O_f = TCV_O.reshape(B * V, 4, 4)
        uv = project_points_robust(pts_mv, K_mv, TCV_O_f)
        boxes_rend = masked_boxes_from_uv(uv, torch.ones(uv.shape[:2], dtype=torch.bool, device=uv.device))
        boxes_crop, _ = cropping.deepim_crops_robust(
            images=None, obs_boxes=boxes_rend, K=K_mv, TCO_pred=TCV_O_f,
            tCR=tCV_R.reshape(B * V, 3), O_vertices=pts_mv,
            output_size=self.cfg.render_size, lamb=self.cfg.crop_lamb,
            return_crops=False, im_size=im_hw,
        )
        return get_K_crop_resize(K_mv, boxes_crop, self.cfg.render_size).reshape(B, V, 3, 3)

    @torch.no_grad()
    def render_views(
        self, meshes: BatchedMeshes, TCV_O: Tensor, KV: Tensor, tCR: Tensor,
        ambient: Tensor | None = None,
    ) -> Tensor:
        """Render V views per hypothesis and stack their channels (rgb,
        normals, depth normalised about the reference point `tCR [B, 3]`):
        `[B, H, W, V * C_render]`, rasterised at `render_at` when it is set
        (intrinsics scaled to it) and upsampled to `render_size`. A per-hypothesis `ambient [B]` lights
        the views with that ambient alone (no point light). The render is
        cut from the gradient, as the JAX package's `stop_gradient` cuts
        it, so autograd keeps none of its intermediates."""
        cfg = self.cfg
        B, V = TCV_O.shape[:2]
        H, W = cfg.render_size
        ras_hw = tuple(cfg.render_at) if cfg.render_at else (H, W)
        if ras_hw != (H, W):
            KV = get_K_resize(KV, (H, W), ras_hw)
        mesh_mv = meshes.repeat_interleave(V)
        if ambient is not None:
            light_ambient = ambient.repeat_interleave(V)
            light_point = torch.zeros_like(light_ambient)
        elif cfg.render_normals:  # normals configs render with pure ambient light
            light_ambient, light_point = 1.0, 0.0
        else:
            light_ambient, light_point = 0.1, 0.4
        args = (mesh_mv.vertices, mesh_mv.normals, mesh_mv.colors, mesh_mv.faces, mesh_mv.face_valid,
                TCV_O.reshape(B * V, 4, 4), KV.reshape(B * V, 3, 3), ras_hw)
        light = dict(light_ambient=light_ambient, light_point=light_point)
        if cfg.renderer == "tiled":
            out = rasterizer_tiled.render_meshes_tiled(
                *args, z_near=cfg.z_near, backface_cull=cfg.backface_cull, **light, **mesh_mv.texture_kw)
        elif cfg.renderer == "scan":  # two-sided, as the JAX package's scan branch
            out = rasterizer.render_meshes(*args, z_near=cfg.z_near, chunk=cfg.face_chunk, **light,
                                           **mesh_mv.texture_kw)
        else:
            raise ValueError(f"unknown renderer {cfg.renderer!r}")
        chans = [out.rgb, out.normals] if cfg.render_normals else [out.rgb]
        if cfg.render_depth:
            chans.append(self.normalize_depth(out.depth[..., None], tCR.repeat_interleave(V, dim=0)))
        r = torch.cat(chans, dim=-1)
        if ras_hw != (H, W):
            r = cropping.resize_bilinear(r, (H, W))
        r = r.reshape(B, V, H, W, -1)
        return r.permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)

    def normalize_depth(self, depth: Tensor, tCR: Tensor) -> Tensor:
        """Depth `[B, ..., 1]` normalised by the reference point's distance
        `tCR [B, 3]` (z)."""
        t = self.cfg.depth_normalization_type
        z = tCR[:, 2].reshape((-1,) + (1,) * (depth.ndim - 1))
        if t == "tCR_scale":
            return depth / z
        if t == "tCR_scale_clamp_center":
            return (depth / z).clamp(0.0, 2.0) - 1.0
        if t == "tCR_center_clamp":
            return (depth - z).clamp(-2.0, 2.0)
        return depth

    def normalize_obs(self, images_crop: Tensor, tCR: Tensor) -> Tensor:
        """The observation crop with its depth channel normalised."""
        if self.cfg.input_depth:
            depth = self.normalize_depth(images_crop[..., 3:4], tCR)
            images_crop = torch.cat([images_crop[..., :3], depth], dim=-1)
        return images_crop

    def update_pose(self, TCO: Tensor, K_crop: Tensor, pose_outputs: Tensor, tCR: Tensor) -> Tensor:
        """Apply the 9D head output."""
        dR = rotmat_from_ortho6d(pose_outputs[..., 0:6])
        return pose_update_with_reference_point(TCO, K_crop, pose_outputs[..., 6:9], dR, tCR)

    # ------------------------------------------------------------------
    # public steps
    # ------------------------------------------------------------------

    def refine_step(
        self, images: Tensor, K: Tensor, TCO_input: Tensor, meshes: BatchedMeshes,
        ambient: Tensor | None = None,
    ) -> dict[str, Tensor]:
        """One DeepIM iteration. `images [B or 1, H, W, 3 or 4]`, rgb in
        [0, 1] (+ depth in metres), `K [B, 3, 3]`, `TCO_input [B, 4, 4]`,
        meshes selected to B, `ambient [B]` as `render_views`."""
        cfg = self.cfg
        if not cfg.input_depth:
            images = images[..., :3]
        TCO_input = normalize_T(TCO_input.detach())
        tCR = TCO_input[..., :3, 3]  # reference point = object origin
        TCV_O = multiview.make_TCO_multiview(
            TCO_input, tCR, multiview_type=cfg.multiview_type, n_views=cfg.n_rendered_views,
            remove_TCO_rendering=cfg.remove_TCO_rendering,
            views_inplane_rotations=cfg.views_inplane_rotations,
        )
        images_crop, K_crop, boxes_rend, boxes_crop = self.crop_inputs(images, K, TCO_input, tCR, meshes)
        KV_crop = self.compute_crops_multiview(
            tuple(images.shape[1:3]), K, TCV_O, TCV_O[..., :3, 3], meshes
        )
        if not cfg.remove_TCO_rendering:
            KV_crop[:, 0] = K_crop
        renders = self.render_views(meshes, TCV_O, KV_crop, tCR, ambient)
        images_crop = self.normalize_obs(images_crop, tCR)
        outputs = self.net_forward(torch.cat([images_crop, renders], dim=-1))
        if cfg.predict_pose_update:
            TCO_output = self.update_pose(TCO_input, K_crop, outputs["pose"], tCR)
        else:
            TCO_output = TCO_input
        return {
            "TCO_input": TCO_input, "TCO_output": TCO_output, "K_crop": K_crop, "tCR": tCR,
            "boxes_rend": boxes_rend, "boxes_crop": boxes_crop, "network_outputs": outputs,
            "renders": renders, "images_crop": images_crop,
        }

    def score_views(
        self, images: Tensor, K: Tensor, TCO_input: Tensor, meshes: BatchedMeshes,
        ambient: Tensor | None = None,
    ) -> dict[str, Tensor]:
        """Coarse classification forward: logits/scores `[B, V]`."""
        cfg = self.cfg
        if not cfg.predict_rendered_views_logits:
            raise ValueError("score_views needs a coarse (logits) configuration")
        if not cfg.input_depth:
            images = images[..., :3]
        TCO_input = normalize_T(TCO_input.detach())
        tCR = TCO_input[..., :3, 3]
        images_crop, K_crop, boxes_rend, boxes_crop = self.crop_inputs(images, K, TCO_input, tCR, meshes)
        if cfg.n_rendered_views == 1:
            TCV_O, KV_crop = TCO_input[:, None], K_crop[:, None]
        else:
            TCV_O = multiview.make_TCO_multiview(
                TCO_input, tCR, multiview_type=cfg.multiview_type, n_views=cfg.n_rendered_views,
                remove_TCO_rendering=cfg.remove_TCO_rendering,
                views_inplane_rotations=cfg.views_inplane_rotations,
            )
            KV_crop = self.compute_crops_multiview(
                tuple(images.shape[1:3]), K, TCV_O, TCV_O[..., :3, 3], meshes
            )
            if not cfg.remove_TCO_rendering:
                KV_crop[:, 0] = K_crop
        renders = self.render_views(meshes, TCV_O, KV_crop, tCR, ambient)
        images_crop = self.normalize_obs(images_crop, tCR)
        logits = self.net_forward(torch.cat([images_crop, renders], dim=-1))["renderings_logits"]
        return {
            "logits": logits, "scores": torch.sigmoid(logits), "K_crop": K_crop, "tCR": tCR,
            "boxes_rend": boxes_rend, "boxes_crop": boxes_crop, "renders": renders,
            "images_crop": images_crop,
        }


def build_pose_predictor(
    cfg: PosePredictorConfig, seed: int = 0, device: str | torch.device = "cuda"
) -> PosePredictor:
    """A PosePredictor with weights drawn from `seed`, on `device`."""
    model = PosePredictor(cfg).init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
