"""Port vs JAX: the whole phased pipeline (coarse -> top-K -> refiner ->
rescore -> top-1) at the small setup of `tests/test_pose_estimator.py`
(SO(3) grid 16, 2 refiner iterations, 3 hypotheses, 48x64 renders,
f32), with the JAX params carried across by `interop.from_jax` and the
mesh database built independently by each package.

Tolerances. The two packages round the SO(3) grid and the initial poses
differently in the last bit (~5e-7), and a pixel whose center lies on a
silhouette edge can then resolve either way: one flipped pixel moves a
random-weight model's logit by ~1e-2 and a refiner update by ~0.03 degree.
So: initial poses atol 1e-5; the top-K ids exactly; logits all within
0.05, and at least 90% of the coarse sweep's and half of the others within
1e-4 (f32 CNN sums in another order); refined and final poses all within
0.1 degree and 0.1 mm, and at least half within 0.001 degree and 0.001 mm.
"""

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
from megapose6d_tpu_torch.ops._precision import pin_f32

pin_f32()
RENDER = (48, 64)
IMG = (96, 128)
CFG = dict(SO3_grid_size=16, n_refiner_iterations=2, n_pose_hypotheses=3, bsz_images=16,
           bsz_objects=8, max_detections=4)


def gt_boxes():
    half = 130 * 0.04 / 0.46  # cube half extent 0.04 at z=0.5, f=130
    box = np.asarray([[64.0 - half, 48.0 - half, 64.0 + half, 48.0 + half]], np.float32)
    return np.concatenate([box, box + 5.0])


def build_estimators():
    """Both packages' estimators on the same weights, and the request: (JAX
    estimator, port estimator, JAX (observation, detections), port
    (observation, detections))."""
    jobjs = RigidObjectDataset([
        RigidObject(label="cube", mesh=make_cube(0.04)),
        RigidObject(label="sphere", mesh=make_uv_sphere(0.035, 8, 12)),
    ])
    jdb = MeshDataBase.from_object_ds(jobjs, max_faces=256, n_points=64, n_sym=2).batched(align=32)
    tobjs = tdb.RigidObjectDataset([
        tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04)),
        tdb.RigidObject(label="sphere", mesh=tio.make_uv_sphere(0.035, 8, 12)),
    ])
    tmesh = tdb.MeshDataBase.from_object_ds(tobjs, max_faces=256, n_points=64, n_sym=2).batched(
        align=32, device="cpu")

    K = np.asarray([[130.0, 0, 64], [0, 130.0, 48], [0, 0, 1]], np.float32)
    TCO_gt = np.eye(4, dtype=np.float32)
    TCO_gt[2, 3] = 0.5
    m1 = jdb.select(jdb.label_to_index(["cube"]))
    obs = np.asarray(rasterizer.render_meshes(
        m1.vertices, m1.normals, m1.colors, m1.faces, m1.face_valid, jnp.asarray(TCO_gt)[None],
        jnp.asarray(K)[None], IMG, light_ambient=1.0, light_point=0.0).rgb)

    models = {}
    for name, make_j, make_t, seed, kw in [
        ("coarse", jpp.make_coarse_config, tpp.make_coarse_config, 0, {}),
        ("refiner", jpp.make_refiner_config, tpp.make_refiner_config, 1,
         dict(n_rendered_views=2, multiview_type="TCO+front_1view")),
    ]:
        jm = jpp.PosePredictor(make_j(render_size=RENDER, **kw))
        with jpp.skip_render_for_init():
            params = jax.jit(jm.init)(
                jax.random.PRNGKey(seed), jnp.zeros((1,) + IMG + (3,)), jnp.asarray(K)[None],
                jnp.asarray(TCO_gt)[None], m1)
        tm = tpp.PosePredictor(make_t(render_size=RENDER, **kw))
        tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
        models[name] = (jm, params, tm)

    jest = JPoseEstimator(models["coarse"][0], models["coarse"][1], models["refiner"][0],
                          models["refiner"][1], jdb, JInferenceConfig(**CFG))
    test = PoseEstimator(models["coarse"][2], models["refiner"][2], tmesh, InferenceConfig(**CFG),
                         device="cpu")
    jargs = (JObservation(images=obs, K=K[None]), jmake_detections(["cube", "sphere"], gt_boxes()))
    targs = (ObservationTensor(torch.as_tensor(np.array(obs)), torch.as_tensor(K[None])),
             make_detections(["cube", "sphere"], gt_boxes(), device="cpu"))
    return jest, test, jargs, targs


@pytest.fixture(scope="module")
def pipelines():
    jest, test, jargs, targs = build_estimators()
    jout, jextra = jest.run_inference_pipeline(*jargs)
    tout, textra = test.run_inference_pipeline(*targs)
    return (jout, jextra), (tout, textra), test


def rot_deg(Ra, Rb):
    cos = (np.trace(np.swapaxes(Ra, -1, -2) @ Rb, axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def assert_poses_close(a, b):
    a, b = np.asarray(a), b.numpy()
    deg = rot_deg(a[..., :3, :3], b[..., :3, :3])
    mm = np.abs(a[..., :3, 3] - b[..., :3, 3]).max(-1) * 1000
    assert deg.max() < 0.1 and mm.max() < 0.1, (deg, mm)
    assert ((deg < 1e-3) & (mm < 1e-3)).mean() >= 0.5, (deg, mm)


def assert_logits_close(a, b, min_tight=0.5):
    d = np.abs(np.asarray(a) - b.numpy())
    assert d.max() < 0.05 and (d < 1e-4).mean() >= min_tight, d


def test_coarse_stage_matches_jax(pipelines):
    (_, jx), (_, tx), _ = pipelines
    np.testing.assert_allclose(jx["coarse"]["TCO_init"], tx["coarse"]["TCO_init"].numpy(), atol=1e-5)
    assert_logits_close(jx["coarse"]["logits"], tx["coarse"]["logits"], min_tight=0.9)
    np.testing.assert_array_equal(jx["coarse"]["top_ids"], tx["coarse"]["top_ids"].numpy())


def test_refiner_and_rescore_match_jax(pipelines):
    (_, jx), (_, tx), _ = pipelines
    assert tuple(tx["refiner"]["trajectory"].shape) == (2, 2, 3, 4, 4)
    assert_poses_close(jx["refiner"]["trajectory"], tx["refiner"]["trajectory"])
    assert_poses_close(jx["refiner"]["TCO_refined"], tx["refiner"]["TCO_refined"])
    assert_logits_close(jx["refiner"]["pose_logits"], tx["refiner"]["pose_logits"])


def test_final_poses_match_jax(pipelines):
    (jout, _), (tout, _), est = pipelines
    assert tout.labels == ["cube", "sphere"]
    assert_poses_close(jout.poses, tout.poses)
    assert_logits_close(jout.infos["pose_logit"].to_numpy(), tout.pose_logit)
    np.testing.assert_allclose(jout.infos["pose_score"], tout.pose_score.numpy(), atol=0.05)
    assert set(est.timing_) == {"coarse", "refiner", "scoring", "total"}


def test_unported_modes_raise():
    db = tdb.MeshDataBase.from_object_ds(
        tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04))]),
        max_faces=64, n_points=16, n_sym=2).batched(align=16, device="cpu")
    coarse = tpp.PosePredictor(tpp.make_coarse_config(render_size=RENDER, backbone="resnet18"))
    refiner = tpp.PosePredictor(tpp.make_refiner_config(render_size=RENDER, backbone="resnet18"))
    # Every mode is ported; detector boxes need a detector to come from.
    for kw in (dict(fused_pipeline=True), dict(SO3_prune_grid_size=8), dict(rescore_f32=True),
               dict(coarse_render_size=(24, 32)), dict(coarse_estimation_type="external"),
               dict(detection_type="detector")):
        PoseEstimator(coarse, refiner, db, InferenceConfig(SO3_grid_size=16, **kw), device="cpu")
    est = PoseEstimator(coarse, refiner, db, InferenceConfig(SO3_grid_size=16), device="cpu")
    obs = ObservationTensor(torch.zeros((1,) + IMG + (3,)), torch.eye(3)[None])
    with pytest.raises(ValueError):
        est.run_inference_pipeline(obs, run_detector=True)
    # The depth stage is ported; asked for without a depth refiner it raises.
    with pytest.raises(ValueError):
        PoseEstimator(coarse, refiner, db, InferenceConfig(run_depth_refiner=True), device="cpu")
