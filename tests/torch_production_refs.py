"""Shared setup of the production-configuration parity tests: the small
scene of `tests/test_torch_pose_estimator.py` (a cube and a UV sphere,
`max_faces` 256, SO(3) grid 16, 48x64 renders, f32) in both packages, a
64-face LOD database of the same objects, and the JAX params carried
across by `interop.from_jax`.

Tolerances (the docstring of `tests/test_torch_pose_estimator.py` says
why): initial poses atol 1e-5; top-K ids exact; logits all within 0.05
and most within 1e-4; poses within 0.1 degree and 0.1 mm, and half within
0.001.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.data import ObservationTensor as JObservation
from megapose6d_tpu.inference import InferenceConfig as JInferenceConfig
from megapose6d_tpu.inference import PoseEstimator as JPoseEstimator
from megapose6d_tpu.inference import make_detections as jmake_detections
from megapose6d_tpu.meshes import MeshDataBase, RigidObject, RigidObjectDataset, make_cube, make_uv_sphere
from megapose6d_tpu.models import pose_predictor as jpp
from megapose6d_tpu.ops import rasterizer
from megapose6d_tpu_torch.data.types import ObservationTensor
from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
from megapose6d_tpu_torch.inference.types import InferenceConfig, make_detections
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.meshes import mesh_db as tdb
from megapose6d_tpu_torch.models import pose_predictor as tpp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for a module that imports this fixture, restored
    after it: these small models gain little from more, and the test
    workers' thread pools contending for the cores slow them several
    fold (as `tests/test_torch_train.py` found)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RENDER = (48, 64)
IMG = (96, 128)
K = np.asarray([[130.0, 0, 64], [0, 130.0, 48], [0, 0, 1]], np.float32)
CFG = dict(SO3_grid_size=16, n_refiner_iterations=2, n_pose_hypotheses=3, bsz_images=16, bsz_objects=8,
           max_detections=4)


def gt_boxes() -> np.ndarray:
    half = 130 * 0.04 / 0.46  # cube half extent 0.04 at z=0.5, f=130
    box = np.asarray([[64.0 - half, 48.0 - half, 64.0 + half, 48.0 + half]], np.float32)
    return np.concatenate([box, box + 5.0])


@dataclasses.dataclass
class Scene:
    jdb: object
    jlod: object
    tdb: tdb.BatchedMeshes
    tlod: tdb.BatchedMeshes
    models: dict  # name -> (JAX model, params, port model)
    obs: np.ndarray

    def jax_estimator(self, coarse="coarse", lod=False, **cfg) -> JPoseEstimator:
        jm, jp, _ = self.models[coarse]
        jr, jrp, _ = self.models["refiner"]
        return JPoseEstimator(jm, jp, jr, jrp, self.jdb, JInferenceConfig(**{**CFG, **cfg}),
                              mesh_db_coarse=self.jlod if lod else None)

    def port_estimator(self, coarse="coarse", lod=False, **cfg) -> PoseEstimator:
        return PoseEstimator(self.models[coarse][2], self.models["refiner"][2], self.tdb,
                             InferenceConfig(**{**CFG, **cfg}), device="cpu",
                             mesh_db_coarse=self.tlod if lod else None)

    def jax_request(self, labels=("cube", "sphere")):
        return JObservation(images=self.obs, K=K[None]), jmake_detections(list(labels), gt_boxes()[: len(labels)])

    def port_request(self, labels=("cube", "sphere")):
        return (ObservationTensor(torch.as_tensor(np.array(self.obs)), torch.as_tensor(K[None])),
                make_detections(list(labels), gt_boxes()[: len(labels)], device="cpu"))


def objects(pkg):
    if pkg == "jax":
        return RigidObjectDataset([RigidObject(label="cube", mesh=make_cube(0.04)),
                                   RigidObject(label="sphere", mesh=make_uv_sphere(0.035, 8, 12))])
    return tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04)),
                                   tdb.RigidObject(label="sphere", mesh=tio.make_uv_sphere(0.035, 8, 12))])


def make_scene(bf16_coarse: bool = False) -> Scene:
    """Both packages' databases and models (coarse, refiner and, with
    `bf16_coarse`, the coarse model computing in bfloat16), and the
    observation of the cube at z = 0.5."""
    jdb, jlod = (MeshDataBase.from_object_ds(objects("jax"), max_faces=f, n_points=64, n_sym=2).batched(align=32)
                 for f in (256, 64))
    tdb_, tlod = (tdb.MeshDataBase.from_object_ds(objects("port"), max_faces=f, n_points=64, n_sym=2).batched(
        align=32, device="cpu") for f in (256, 64))
    TCO_gt = np.eye(4, dtype=np.float32)
    TCO_gt[2, 3] = 0.5
    m1 = jdb.select(jdb.label_to_index(["cube"]))
    obs = np.asarray(rasterizer.render_meshes(
        m1.vertices, m1.normals, m1.colors, m1.faces, m1.face_valid, jnp.asarray(TCO_gt)[None],
        jnp.asarray(K)[None], IMG, light_ambient=1.0, light_point=0.0).rgb)
    specs = [("coarse", jpp.make_coarse_config, tpp.make_coarse_config, 0, {}),
             ("refiner", jpp.make_refiner_config, tpp.make_refiner_config, 1,
              dict(n_rendered_views=2, multiview_type="TCO+front_1view"))]
    if bf16_coarse:
        specs.append(("coarse_bf16", jpp.make_coarse_config, tpp.make_coarse_config, 0,
                      dict(compute_dtype="bfloat16")))
    models = {}
    for name, make_j, make_t, seed, kw in specs:
        jm = jpp.PosePredictor(make_j(render_size=RENDER, **kw))
        with jpp.skip_render_for_init():
            params = jax.jit(jm.init)(
                jax.random.PRNGKey(seed), jnp.zeros((1,) + IMG + (3,)), jnp.asarray(K)[None],
                jnp.asarray(TCO_gt)[None], m1)
        tm = tpp.PosePredictor(make_t(render_size=RENDER, **kw))
        tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
        models[name] = (jm, params, tm)
    return Scene(jdb, jlod, tdb_, tlod, models, obs)


def rot_deg(Ra, Rb):
    cos = (np.trace(np.swapaxes(Ra, -1, -2) @ Rb, axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def assert_poses_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    deg = rot_deg(a[..., :3, :3], b[..., :3, :3])
    mm = np.abs(a[..., :3, 3] - b[..., :3, 3]).max(-1) * 1000
    assert deg.max() < 0.1 and mm.max() < 0.1, (deg, mm)
    assert ((deg < 1e-3) & (mm < 1e-3)).mean() >= 0.5, (deg, mm)


def assert_logits_close(a, b, min_tight=0.5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(a)
    d = np.abs(a[fin] - b[fin])
    assert d.max() < 0.05 and (d < 1e-4).mean() >= min_tight, d


def assert_outputs_match(jout, jx, tout, tx):
    """The coarse stage, top-K, refiner, rescore and final poses of a port
    run against a JAX run on the same request."""
    np.testing.assert_allclose(jx["coarse"]["TCO_init"], tx["coarse"]["TCO_init"].numpy(), atol=1e-5)
    assert_logits_close(jx["coarse"]["logits"], tx["coarse"]["logits"], min_tight=0.9)
    np.testing.assert_array_equal(jx["coarse"]["top_ids"], tx["coarse"]["top_ids"].numpy())
    assert_poses_close(jx["refiner"]["trajectory"], tx["refiner"]["trajectory"])
    assert_logits_close(jx["refiner"]["pose_logits"], tx["refiner"]["pose_logits"])
    assert_poses_close(jout.poses, tout.poses)
    assert_logits_close(jout.infos["pose_logit"].to_numpy(), tout.pose_logit)
