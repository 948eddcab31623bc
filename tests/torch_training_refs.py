"""Shared pieces of the trainer's parity tests (`tests/test_torch_*.py`):
the JAX package's own random draws, laid out as the port's draw functions
return them, and one small scene in both packages.

Each `jax_*_draws` repeats the key splits of the JAX function it names, so
that the port's apply functions, fed these draws, must give that JAX
function's output on the same key.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from megapose6d_tpu.meshes import MeshDataBase, RigidObject, RigidObjectDataset, make_cube, make_uv_sphere
from megapose6d_tpu.models import pose_predictor as jpp
import megapose6d_tpu.training.forward_loss  # noqa: F401 (the package exports a function of that name)
from megapose6d_tpu.training.config import TrainingConfig as JTrainingConfig
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.meshes import mesh_db as tdb
from megapose6d_tpu_torch.training.config import TrainingConfig
from megapose6d_tpu_torch.training.forward_loss import MULTIVIEW_PAPER_CANDIDATES, BatchPoseData

JBatchPoseData = sys.modules["megapose6d_tpu.training.forward_loss"].BatchPoseData
INPUT = (60, 80)
RENDER = (48, 64)


def t(x, dtype=None) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def pose_noise_draws(key, n: int) -> dict:
    """`add_pose_noise(key, ...)`'s normals for `n` poses."""
    kr, kt = jax.random.split(key)
    return dict(euler=t(jax.random.normal(kr, (n, 3))), trans=t(jax.random.normal(kt, (n, 3))))


def small_rotation_draws(key, shape) -> tuple[torch.Tensor, torch.Tensor]:
    """`small_random_rotations(key, shape, ...)`'s axis normals and uniforms."""
    k_axis, k_ang = jax.random.split(key)
    return t(jax.random.normal(k_axis, tuple(shape) + (3,))), t(jax.random.uniform(k_ang, tuple(shape)))


def jax_hypotheses_draws(key, cfg: TrainingConfig, B: int) -> dict:
    """`make_hypotheses(key, cfg, ...)`'s draws, as `draw_hypotheses` lays
    them out."""
    H, method = cfg.n_hypotheses, cfg.hypotheses_init_method
    if method == "coarse_z_up+auto-depth":
        return pose_noise_draws(key, B)
    if method == "refiner_gt+noise":
        return pose_noise_draws(key, B * H)
    if method == "coarse_classif_multiview_paper":
        k_noise, k_perm, k_force, k_pos = jax.random.split(key, 4)
        perm = jax.vmap(lambda k: jax.random.permutation(k, MULTIVIEW_PAPER_CANDIDATES)[:H])(
            jax.random.split(k_perm, B))
        return dict(**pose_noise_draws(k_noise, B), perm=t(perm, torch.long),
                    force=t(jax.random.uniform(k_force, (B,))),
                    pos_slot=t(jax.random.randint(k_pos, (B,), 0, H), torch.long))
    if method == "coarse_classif_grid":
        k_rot, k_small, k_force, k_pos, k_hard, k_hsel = jax.random.split(key, 6)
        small_axis, small_u = small_rotation_draws(k_small, (B,))
        hard_axis, hard_u = small_rotation_draws(k_hard, (B, H))
        return dict(rot=t(jax.random.normal(k_rot, (B, H, 4))), small_axis=small_axis, small_u=small_u,
                    force=t(jax.random.uniform(k_force, (B,))),
                    pos_slot=t(jax.random.randint(k_pos, (B,), 0, H), torch.long),
                    hard_axis=hard_axis, hard_u=hard_u, hard_sel=t(jax.random.uniform(k_hsel, (B, H))))
    raise ValueError(method)


def jax_forward_loss_draws(key, cfg: TrainingConfig, B: int, n_points_mesh: int) -> dict:
    """`forward_loss(..., key, ...)`'s draws, as `draw_forward_loss` lays
    them out."""
    k_hyp, k_pts, k_amb = jax.random.split(key, 3)
    ambient = None
    if cfg.random_ambient_light:
        ambient = t(jax.random.uniform(k_amb, (B * cfg.n_hypotheses,), minval=0.7, maxval=1.0))
    return {"hyp": jax_hypotheses_draws(k_hyp, cfg, B),
            "point_scores": t(jax.random.uniform(k_pts, (B, n_points_mesh))), "ambient": ambient}


def jax_synthetic_draws(key, B: int, n_labels: int, z_range=(0.35, 0.9), domain_rand=False,
                        occlude=False, n_quats: int = 4096) -> dict:
    """`synthetic_batch_fn(...)(key)`'s draws, as `SyntheticBatches.draw`
    lays them out."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    d = dict(mesh_idx=t(jax.random.randint(k1, (B,), 0, n_labels), torch.long),
             quat_idx=t(jax.random.randint(k2, (B,), 0, n_quats), torch.long),
             z=t(jax.random.uniform(k3, (B, 1), minval=z_range[0], maxval=z_range[1])),
             xy=t(jax.random.uniform(k4, (B, 2), minval=-0.05, maxval=0.05)))
    if domain_rand:
        bg = [jax.random.split(k, 3) for k in jax.random.split(jax.random.fold_in(key, 103), B)]
        d.update(
            ambient=t(jax.random.uniform(jax.random.fold_in(key, 101), (B,), minval=0.5, maxval=1.0)),
            point=t(jax.random.uniform(jax.random.fold_in(key, 102), (B,), minval=0.0, maxval=0.5)),
            bg_coarse=t(np.stack([jax.random.uniform(k[0], (6, 8, 3)) for k in bg])),
            bg_fine=t(np.stack([jax.random.uniform(k[1], (24, 32, 3), minval=-0.15, maxval=0.15)
                                for k in bg])),
            bg_gain=t(np.stack([jax.random.uniform(k[2], (), minval=0.4, maxval=1.0) for k in bg])))
    if occlude:
        d.update(
            mesh_idx2=t(jax.random.randint(jax.random.fold_in(key, 104), (B,), 0, n_labels), torch.long),
            quat_idx2=t(jax.random.randint(jax.random.fold_in(key, 105), (B,), 0, n_quats), torch.long),
            offset=t(jax.random.uniform(jax.random.fold_in(key, 106), (B, 3),
                                        minval=jnp.asarray([-0.09, -0.09, -0.12]),
                                        maxval=jnp.asarray([0.09, 0.09, -0.02]))))
    return d


def j_db(n_points: int = 128, n_sym: int = 4):
    """The cube and sphere of `tests/test_torch_pose_predictor.py` (256 faces)."""
    objs = RigidObjectDataset([RigidObject(label="cube", mesh=make_cube(0.04)),
                               RigidObject(label="sphere", mesh=make_uv_sphere(0.035, 8, 12))])
    return MeshDataBase.from_object_ds(objs, max_faces=256, n_points=n_points, n_sym=n_sym).batched(align=32)


def t_db(n_points: int = 128, n_sym: int = 4):
    objs = tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04)),
                                   tdb.RigidObject(label="sphere", mesh=tio.make_uv_sphere(0.035, 8, 12))])
    return tdb.MeshDataBase.from_object_ds(objs, max_faces=256, n_points=n_points, n_sym=n_sym).batched(
        align=32, device="cpu")


def jcfg(cfg: TrainingConfig) -> JTrainingConfig:
    """The JAX package's TrainingConfig with the port config's fields."""
    return JTrainingConfig(**dataclasses.asdict(cfg))


def scene(rng: np.random.RandomState, B: int, mesh_idx: list[int]):
    """A batch in numpy: random images, one camera, ground-truth poses
    near the optical axis, boxes of the projected mesh points."""
    rgbs = rng.uniform(size=(B,) + INPUT + (3,)).astype(np.float32)
    K = np.tile(np.asarray([[95.0, 0, 39.5], [0, 95.0, 29.5], [0, 0, 1]], np.float32), (B, 1, 1))
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        a = rng.uniform(0, math.pi)
        Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        TCO[b, :3, :3] = np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx
    TCO[:, :3, 3] = np.stack([rng.normal(scale=0.01, size=B), rng.normal(scale=0.01, size=B),
                              rng.uniform(0.35, 0.5, size=B)], -1)
    return dict(rgbs=rgbs, K=K, TCO=TCO.astype(np.float32), mesh_idx=np.asarray(mesh_idx, np.int32))


def batches(sc: dict, jdb, tdb_):
    """The scene as the JAX package's and the port's BatchPoseData, with
    boxes from the JAX package's projection of the mesh points."""
    from megapose6d_tpu.ops.camera import masked_boxes_from_uv, project_points_robust

    pts = jdb.points[jnp.asarray(sc["mesh_idx"])]
    uv = project_points_robust(pts, jnp.asarray(sc["K"]), jnp.asarray(sc["TCO"]))
    boxes = np.asarray(masked_boxes_from_uv(uv, jnp.ones(uv.shape[:2], bool)))
    jb = JBatchPoseData(rgbs=jnp.asarray(sc["rgbs"]), K=jnp.asarray(sc["K"]), TCO=jnp.asarray(sc["TCO"]),
                           bboxes=jnp.asarray(boxes), mesh_idx=jnp.asarray(sc["mesh_idx"]))
    tb = BatchPoseData(rgbs=t(sc["rgbs"]), K=t(sc["K"]), TCO=t(sc["TCO"]), bboxes=t(boxes),
                       mesh_idx=t(sc["mesh_idx"], torch.long))
    return jb, tb


def init_jax_model(cfg: TrainingConfig, jdb, seed: int):
    """The JAX PosePredictor of `cfg` and params from `seed` (the render
    skipped, as the JAX package's own device init does)."""
    model = jpp.PosePredictor(jpp.PosePredictorConfig(**jcfg(cfg).model_config_kwargs()))
    with jpp.skip_render_for_init():
        params = jax.jit(model.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1,) + INPUT + (3,)), jnp.eye(3)[None] * 100.0,
            jnp.eye(4)[None].at[0, 2, 3].set(0.5), jdb.select(jnp.zeros((1,), jnp.int32)))
    return model, params
