"""Training hypotheses and the coarse and refiner losses.

Counterpart of `megapose6d_tpu/training/forward_loss.py`. Every random
draw is split from the arithmetic: `draw_forward_loss` takes a
`torch.Generator` and returns the normals, uniforms, integers and
permutations that one loss evaluation uses, and `forward_loss` is a
deterministic function of them, so the tests can feed it the JAX
package's own draws. Draws are made on the CPU and moved to the batch's
device, so a seed gives the same draws on the CPU and on the card. The
JAX package's `lax.scan` over refiner iterations is a Python loop; the
renders are cut from the gradient inside `PosePredictor`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..meshes.mesh_db import BatchedMeshes
from ..models.pose_predictor import PosePredictor
from ..ops import losses as loss_ops
from ..ops import multiview
from ..ops.pose_init import tco_init_from_boxes_autodepth_with_R, tco_init_from_boxes_zup_autodepth
from ..ops.se3 import (
    add_pose_noise,
    draw_pose_noise,
    draw_random_rotations,
    draw_small_random_rotations,
    geodesic_distance,
    random_rotations,
    small_random_rotations,
)
from .config import TrainingConfig

Tensor = torch.Tensor

# coarse_classif_multiview_paper's candidates: the 26 sphere views (the
# noised ground truth's own view removed), each at 4 in-plane rotations.
MULTIVIEW_PAPER_CANDIDATES = 26 * 4
# Share of samples that get a positive hypothesis forced in (the
# reference's `np.random.rand() > 0.3`).
FORCE_POSITIVE_ABOVE = 0.3


@dataclasses.dataclass
class BatchPoseData:
    """A training batch: `rgbs [B, H, W, 3]` in [0, 1], `K [B, 3, 3]`, the
    ground truth `TCO [B, 4, 4]`, `bboxes [B, 4]` (x1, y1, x2, y2),
    `mesh_idx [B]` long, optional `depths [B, H, W]` in metres."""

    rgbs: Tensor
    K: Tensor
    TCO: Tensor
    bboxes: Tensor
    mesh_idx: Tensor
    depths: Tensor | None = None

    @property
    def batch_size(self) -> int:
        return self.rgbs.shape[0]

    def images(self) -> Tensor:
        if self.depths is None:
            return self.rgbs
        return torch.cat([self.rgbs, self.depths[..., None]], -1)

    def replace(self, **changes) -> "BatchPoseData":
        return dataclasses.replace(self, **changes)

    def _map(self, fn) -> "BatchPoseData":
        return BatchPoseData(**{
            f.name: None if getattr(self, f.name) is None else fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
        })

    def to(self, device: str | torch.device, non_blocking: bool = False) -> "BatchPoseData":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "BatchPoseData":
        """Every tensor in page-locked memory (the DataLoader's pin hook)."""
        return self._map(lambda t: t.pin_memory())


def draws_to(draws, device: str | torch.device):
    """A nested dict of draws with every tensor moved to `device`."""
    if isinstance(draws, dict):
        return {k: draws_to(v, device) for k, v in draws.items()}
    return None if draws is None else draws.to(device)


def draw_hypotheses(cfg: TrainingConfig, B: int, generator: torch.Generator) -> dict[str, Tensor]:
    """The draws of `make_hypotheses` for `B` samples, on the CPU."""
    H = cfg.n_hypotheses
    method = cfg.hypotheses_init_method
    g = generator
    if method in ("coarse_z_up+auto-depth", "coarse_classif_multiview_paper"):
        euler, trans = draw_pose_noise(B, g)
        d = dict(euler=euler, trans=trans)
        if method == "coarse_classif_multiview_paper":
            d.update(
                perm=torch.rand((B, MULTIVIEW_PAPER_CANDIDATES), generator=g).argsort(dim=1)[:, :H],
                force=torch.rand((B,), generator=g),
                pos_slot=torch.randint(0, H, (B,), generator=g),
            )
        return d
    if method == "refiner_gt+noise":
        euler, trans = draw_pose_noise(B * H, g)
        return dict(euler=euler, trans=trans)
    if method == "coarse_classif_grid":
        small_axis, small_u = draw_small_random_rotations((B,), g)
        hard_axis, hard_u = draw_small_random_rotations((B, H), g)
        return dict(
            rot=draw_random_rotations((B, H), g), small_axis=small_axis, small_u=small_u,
            force=torch.rand((B,), generator=g), pos_slot=torch.randint(0, H, (B,), generator=g),
            hard_axis=hard_axis, hard_u=hard_u, hard_sel=torch.rand((B, H), generator=g),
        )
    raise ValueError(method)


def make_hypotheses(
    cfg: TrainingConfig, batch: BatchPoseData, meshes: BatchedMeshes, draws: dict[str, Tensor]
) -> tuple[Tensor, Tensor | None]:
    """Initial poses `[B, n_hyp, 4, 4]` and, for the coarse methods, the
    positive labels `[B, n_hyp]` (1.0 / 0.0); `meshes` selected to B."""
    B = batch.batch_size
    H = cfg.n_hypotheses
    method = cfg.hypotheses_init_method

    if method == "coarse_z_up+auto-depth":
        if H != 1:
            raise ValueError("coarse_z_up+auto-depth takes one hypothesis")
        TCO_init = tco_init_from_boxes_zup_autodepth(batch.bboxes, meshes.points, batch.K)
        TCO_init = add_pose_noise(TCO_init, euler_deg_std=(0, 0, 0), trans_std=(0.01, 0.01, 0.05),
                                  euler_normals=draws["euler"], trans_normals=draws["trans"])
        return TCO_init[:, None], None

    if method == "refiner_gt+noise":
        flat = batch.TCO.repeat_interleave(H, dim=0)
        noisy = add_pose_noise(flat, cfg.init_euler_deg_std, cfg.init_trans_std,
                               euler_normals=draws["euler"], trans_normals=draws["trans"])
        return noisy.reshape(B, H, 4, 4), None

    if method == "coarse_classif_multiview_paper":
        TCO_gt_noise = add_pose_noise(batch.TCO, cfg.init_euler_deg_std, cfg.init_trans_std,
                                      euler_normals=draws["euler"], trans_normals=draws["trans"])
        TCV_O = multiview.make_TCO_multiview(
            TCO_gt_noise, TCO_gt_noise[..., :3, 3], multiview_type="sphere_26views", n_views=27,
            remove_TCO_rendering=True, views_inplane_rotations=True,
        )  # [B, 104, 4, 4]
        # A hypothesis is positive iff it is candidate 0 (the noised ground
        # truth's view); a sample with none gets one forced in at a random
        # slot with probability 0.7.
        perm = draws["perm"]
        has_pos = (perm == 0).any(dim=1)
        force = (draws["force"] > FORCE_POSITIVE_ABOVE) & ~has_pos
        slot = torch.nn.functional.one_hot(draws["pos_slot"], H).bool()
        perm = torch.where(force[:, None] & slot, 0, perm)
        is_positive = (perm == 0).float()
        TCO_init = torch.gather(TCV_O, 1, perm[..., None, None].expand(B, H, 4, 4))
        return TCO_init, is_positive

    if method == "coarse_classif_grid":
        # The inference task's candidates: grid-like rotations box-fitted
        # with autodepth. Negatives are Haar-uniform or (a share
        # `coarse_hard_neg_frac`) the ground truth turned by up to
        # `coarse_hard_neg_max_deg`; the positive, forced in with
        # probability 0.7, is the ground truth turned by up to 0.8 x
        # `coarse_pos_angle_deg`. Labels are symmetry-aware: positive iff
        # within `coarse_pos_angle_deg` of the ground truth's orbit.
        thresh = math.radians(cfg.coarse_pos_angle_deg)
        R_gt = batch.TCO[:, :3, :3]
        R_rand = random_rotations(normals=draws["rot"])  # [B, H, 3, 3]
        R_hard = R_gt[:, None] @ small_random_rotations(
            None, math.radians(cfg.coarse_hard_neg_max_deg), draws["hard_axis"], draws["hard_u"])
        use_hard = draws["hard_sel"] < cfg.coarse_hard_neg_frac
        R_rand = torch.where(use_hard[..., None, None], R_hard, R_rand)
        R_pos = R_gt @ small_random_rotations(None, thresh * 0.8, draws["small_axis"], draws["small_u"])
        force = draws["force"] > FORCE_POSITIVE_ABOVE
        slot = torch.nn.functional.one_hot(draws["pos_slot"], H).bool()
        put = force[:, None] & slot
        R_hyp = torch.where(put[..., None, None], R_pos[:, None], R_rand)
        TCO_init = tco_init_from_boxes_autodepth_with_R(
            batch.bboxes.repeat_interleave(H, dim=0), meshes.points.repeat_interleave(H, dim=0),
            batch.K.repeat_interleave(H, dim=0), R_hyp.reshape(B * H, 3, 3),
        ).reshape(B, H, 4, 4)
        R_sym = R_gt[:, None] @ meshes.symmetries[:, :, :3, :3]  # [B, S, 3, 3]
        d = geodesic_distance(R_hyp[:, :, None], R_sym[:, None])  # [B, H, S]
        d = torch.where(meshes.sym_valid[:, None, :], d, torch.inf).amin(-1)
        return TCO_init, (d <= thresh).float()

    raise ValueError(method)


def draw_forward_loss(
    cfg: TrainingConfig, B: int, n_points_mesh: int, generator: torch.Generator
) -> dict:
    """Every draw of one `forward_loss` for `B` samples, on the CPU: the
    hypotheses', the uniform scores whose top `n_points_loss` pick the
    loss points among the mesh's `n_points_mesh`, and the per-hypothesis
    ambient light in [0.7, 1) when `random_ambient_light`."""
    d = {
        "hyp": draw_hypotheses(cfg, B, generator),
        "point_scores": torch.rand((B, n_points_mesh), generator=generator),
        "ambient": None,
    }
    if cfg.random_ambient_light:
        d["ambient"] = torch.rand((B * cfg.n_hypotheses,), generator=generator) * 0.3 + 0.7
    return d


def forward_loss(
    model: PosePredictor,
    cfg: TrainingConfig,
    batch: BatchPoseData,
    mesh_db: BatchedMeshes,
    n_iterations: int,
    draws: dict,
) -> tuple[Tensor, dict[str, Tensor]]:
    """The scalar training loss and its metrics, from `draws` (see
    `draw_forward_loss`, on the batch's device; the JAX package's key)."""
    B = batch.batch_size
    H = cfg.n_hypotheses
    meshes = mesh_db.select(batch.mesh_idx)
    TCO_init, is_positive = make_hypotheses(cfg, batch, meshes, draws["hyp"])

    # Hypotheses flattened into the batch axis.
    images_f = batch.images().repeat_interleave(H, dim=0)
    K_f = batch.K.repeat_interleave(H, dim=0)
    meshes_f = mesh_db.select(batch.mesh_idx.repeat_interleave(H))
    TCO_f = TCO_init.reshape(B * H, 4, 4)
    ambient = draws["ambient"]

    # The symmetry-aware ground-truth set and the loss points.
    TCO_possible_gt = batch.TCO[:, None] @ meshes.symmetries  # [B, S, 4, 4]
    n_pts = min(cfg.n_points_loss, meshes.points.shape[1])
    pt_ids = torch.topk(draws["point_scores"], n_pts, dim=1).indices
    points = torch.gather(meshes.points, 1, pt_ids[..., None].expand(B, n_pts, 3))

    metrics: dict[str, Tensor] = {}
    loss_total = torch.zeros((), device=TCO_f.device)

    if cfg.predict_pose_update:
        TCO_possible_gt_f = TCO_possible_gt.repeat_interleave(H, dim=0)
        sym_valid_f = meshes.sym_valid.repeat_interleave(H, dim=0)
        points_f = points.repeat_interleave(H, dim=0)
        sums = dict.fromkeys(("loss", "loss_orn", "loss_xy", "loss_z"), 0.0)
        T = TCO_f
        for _ in range(n_iterations):
            out = model.refine_step(images_f, K_f, T, meshes_f, ambient=ambient)
            loss_iter, loss_data = loss_ops.loss_refiner_CO_disentangled_reference_point(
                TCO_possible_gt=TCO_possible_gt_f, TCO_input=out["TCO_input"],
                refiner_outputs=out["network_outputs"]["pose"], K_crop=out["K_crop"],
                points=points_f, tCR=out["tCR"], sym_valid=sym_valid_f,
            )
            sums["loss"] = sums["loss"] + loss_iter.mean()
            for k in ("loss_orn", "loss_xy", "loss_z"):
                sums[k] = sums[k] + loss_data[k].mean()
            T = out["TCO_output"]
        loss_pose = sums["loss"] / n_iterations
        loss_total = loss_total + cfg.loss_alpha_pose * loss_pose
        metrics["loss_TCO"] = loss_pose.detach()
        for k in ("loss_orn", "loss_xy", "loss_z"):
            metrics[f"loss_TCO-{k}"] = (sums[k] / n_iterations).detach()

    if cfg.predict_rendered_views_logits:
        if is_positive is None:
            raise ValueError(f"{cfg.hypotheses_init_method} gives no labels for the logits head")
        out = model.score_views(images_f, K_f, TCO_f, meshes_f, ambient=ambient)
        logits = out["logits"].reshape(B, H) / cfg.renderings_logits_temperature
        bce = optax_sigmoid_bce(logits, is_positive).mean()
        loss_total = loss_total + cfg.loss_alpha_renderings_confidence * bce
        metrics["loss_renderings_confidence"] = bce.detach()
        metrics["views_accuracy"] = ((logits > 0) == (is_positive > 0.5)).float().mean()

    metrics["loss_total"] = loss_total.detach()
    return loss_total, metrics


def optax_sigmoid_bce(logits: Tensor, labels: Tensor) -> Tensor:
    """Binary cross-entropy with logits, in optax's stable form."""
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
