"""Port vs JAX: RGB-D inputs and renders, the named models, the pipeline's
depth stage and the RGB-D scripts.

The same numpy inputs go through both packages on the CPU, in f32 with
TF32 off. Tolerances:
  - `normalize_depth` (four types) and the depth crop: 1e-6 (the crop's
    weights are the same matmuls as the rgb channels'), and the crop's
    validity mask exactly;
  - RGB-D `refine_step` (input depth, depth renders, 4 views, so a
    4 + 7 x 4 = 32-channel stem) with JAX's params carried across: the f32
    tolerances of `tests/test_torch_pose_predictor.py`, crops and renders
    1e-4, 9D outputs 1e-4;
  - the pipeline with an ICP stage: the pose tolerances of
    `tests/test_torch_pose_estimator.py` (0.1 degree and 0.1 mm) on the
    RGB poses and on the depth-refined ones, equal `valid`;
  - the demo world's mesh database from the dataset's PLY and PNG files
    against the JAX script's procedural one: faces, face masks, textures
    and symmetry masks exactly; vertices, points, uvs, colours, diameters
    and symmetries within 1e-6, normals within 1e-5 (the PLY stores
    millimetres as text).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.models import pose_predictor as jpp
from megapose6d_tpu.ops import cropping as jcrop
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.models import pose_predictor as tpp
from megapose6d_tpu_torch.ops import cropping as tcrop
from megapose6d_tpu_torch.ops._precision import pin_f32

pin_f32()
ROOT = Path(__file__).resolve().parents[1]
RENDER = (48, 64)
IMG = (96, 128)
RGBD = dict(input_depth=True, render_depth=True, depth_normalization_type="tCR_scale_clamp_center")
K = np.asarray([[130.0, 0, 64], [0, 130.0, 48], [0, 0, 1]], np.float32)


def T_(x):
    return torch.as_tensor(np.array(x))


def test_named_models_equal_jax():
    from megapose6d_tpu.inference.load_model import NAMED_MODELS as J
    from megapose6d_tpu_torch.inference.load_model import NAMED_MODELS as T

    assert T == J


@pytest.mark.parametrize("kind", ["tCR_scale", "tCR_scale_clamp_center", "tCR_center_clamp", "none"])
def test_normalize_depth_matches_jax(rng, kind):
    depth = np.where(rng.rand(3, 20, 30, 1) < 0.3, 0, rng.uniform(0.1, 3.0, (3, 20, 30, 1))).astype(np.float32)
    tCR = rng.uniform(-0.1, 1.2, (3, 3)).astype(np.float32)
    jm = jpp.PosePredictor(jpp.make_refiner_config(depth_normalization_type=kind))
    tm = tpp.PosePredictor(tpp.make_refiner_config(depth_normalization_type=kind, backbone="resnet18",
                                                   render_size=RENDER))
    a = np.asarray(jm.normalize_depth(jnp.asarray(depth), jnp.asarray(tCR)))
    np.testing.assert_allclose(tm.normalize_depth(T_(depth), T_(tCR)).numpy(), a, atol=1e-6)
    obs = np.concatenate([rng.rand(3, 20, 30, 3).astype(np.float32), depth], -1)
    jin = jpp.PosePredictor(jpp.make_refiner_config(input_depth=True, depth_normalization_type=kind))
    tin = tpp.PosePredictor(tpp.make_refiner_config(input_depth=True, depth_normalization_type=kind,
                                                    backbone="resnet18", render_size=RENDER))
    np.testing.assert_allclose(tin.normalize_obs(T_(obs), T_(tCR)).numpy(),
                               np.asarray(jin.normalize_obs(jnp.asarray(obs), jnp.asarray(tCR))), atol=1e-6)
    with pytest.raises(ValueError):
        tpp.PosePredictor(tpp.make_refiner_config(depth_normalization_type="other"))


def test_depth_crop_mask_matches_jax(rng):
    img = rng.rand(2, 60, 80, 4).astype(np.float32)
    depth = rng.uniform(0.4, 0.6, (2, 60, 80)).astype(np.float32)
    depth[:, 20:30, 30:50] = 0.0  # a hole the crops resample across
    depth[rng.rand(2, 60, 80) < 0.02] = 0.0
    img[..., 3] = depth
    boxes = np.asarray([[10.0, 5, 70, 50], [25.3, 12.7, 48.1, 40.2]], np.float32)  # down- and upsampled
    a = np.asarray(jcrop.crop_images(jnp.asarray(img), jnp.asarray(boxes), (24, 32), depth_dim=3))
    b = tcrop.crop_images(T_(img), T_(boxes), (24, 32), depth_dim=3).numpy()
    np.testing.assert_array_equal(a[..., 3] == 0, b[..., 3] == 0)
    assert 0 < (b[..., 3] == 0).mean() < 0.5
    np.testing.assert_allclose(b, a, atol=1e-6)


def db_pair():
    from megapose6d_tpu.meshes import MeshDataBase, RigidObject, RigidObjectDataset, make_cube, make_uv_sphere
    from megapose6d_tpu_torch.meshes import io as tio
    from megapose6d_tpu_torch.meshes import mesh_db as tdb

    jdb = MeshDataBase.from_object_ds(RigidObjectDataset([
        RigidObject(label="cube", mesh=make_cube(0.04)),
        RigidObject(label="sphere", mesh=make_uv_sphere(0.035, 8, 12)),
    ]), max_faces=256, n_points=64, n_sym=2).batched(align=32)
    tmesh = tdb.MeshDataBase.from_object_ds(tdb.RigidObjectDataset([
        tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04)),
        tdb.RigidObject(label="sphere", mesh=tio.make_uv_sphere(0.035, 8, 12)),
    ]), max_faces=256, n_points=64, n_sym=2).batched(align=32, device="cpu")
    return jdb, tmesh


def init_pair(make_j, make_t, seed, **kw):
    jm = jpp.PosePredictor(make_j(render_size=RENDER, backbone="resnet18-spatial", **kw))
    jdb, _ = db_pair()
    with jpp.skip_render_for_init():
        params = jax.jit(jm.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1,) + IMG + (4 if kw.get("input_depth") else 3,)),
            jnp.asarray(K)[None], jnp.eye(4)[None].at[0, 2, 3].set(0.5), jdb.select(jnp.zeros((1,), jnp.int32)))
    tm = tpp.PosePredictor(make_t(render_size=RENDER, backbone="resnet18-spatial", **kw))
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def scene():
    """A cube at 0.5 m: rgb + depth observation `[1, H, W, 4]`."""
    from megapose6d_tpu.ops import rasterizer

    jdb, _ = db_pair()
    m = jdb.select(jdb.label_to_index(["cube"]))
    TCO = np.eye(4, dtype=np.float32)
    TCO[:3, 3] = [0.005, -0.003, 0.5]
    out = rasterizer.render_meshes(m.vertices, m.normals, m.colors, m.faces, m.face_valid,
                                   jnp.asarray(TCO)[None], jnp.asarray(K)[None], IMG,
                                   light_ambient=1.0, light_point=0.0)
    obs = np.concatenate([np.asarray(out.rgb), np.asarray(out.depth)[..., None]], -1)
    return obs.astype(np.float32), TCO


def test_rgbd_refine_step_matches_jax(scene):
    """4 views with normals and depth, and the measured depth as input:
    the stem takes 32 channels."""
    obs, TCO_gt = scene
    jm, params, tm = init_pair(jpp.make_refiner_config, tpp.make_refiner_config, 3, **RGBD)
    assert tm.cfg.n_inputs == 32 and tm.backbone.stem.weight.shape[1] == 32
    assert params["params"]["backbone"]["Conv_0"]["kernel"].shape[2] == 32
    jdb, tdb_ = db_pair()
    rng = np.random.RandomState(0)
    TCO = np.stack([TCO_gt, TCO_gt]).copy()
    TCO[:, :3, 3] += rng.normal(scale=0.01, size=(2, 3))
    labels = ["cube", "sphere"]
    Kb = np.stack([K, K])
    obs = np.concatenate([obs, obs])
    jout = jax.jit(lambda p, *a: jm.apply(p, *a, method=jpp.PosePredictor.refine_step))(
        params, jnp.asarray(obs), jnp.asarray(Kb), jnp.asarray(TCO), jdb.select(jdb.label_to_index(labels)))
    with torch.no_grad():
        tout = tm.refine_step(T_(obs), T_(Kb), T_(TCO), tdb_.select(tdb_.label_to_index(labels)))
    assert tout["renders"].shape[-1] == 28 and tout["images_crop"].shape[-1] == 4
    np.testing.assert_allclose(tout["images_crop"].numpy(), np.asarray(jout["images_crop"]), atol=1e-4)
    np.testing.assert_allclose(tout["renders"].numpy(), np.asarray(jout["renders"]), atol=1e-4)
    depth_ch = tout["renders"][..., 6::7]
    assert (depth_ch > -1).any() and depth_ch.min() >= -1 and depth_ch.max() <= 1
    np.testing.assert_allclose(tout["network_outputs"]["pose"].numpy(),
                               np.asarray(jout["network_outputs"]["pose"]), atol=1e-4)
    np.testing.assert_allclose(tout["TCO_output"].numpy(), np.asarray(jout["TCO_output"]), atol=1e-5)


def rot_deg(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64), axis=(-2, -1))
    return np.degrees(2 * np.arcsin(np.clip(d / (2 * np.sqrt(2)), 0, 1)))


def assert_poses_close(a, b, deg=0.1, mm=0.1):
    a, b = np.asarray(a), np.asarray(b)
    d = rot_deg(a[..., :3, :3], b[..., :3, :3])
    t = np.abs(a[..., :3, 3] - b[..., :3, 3]).max(-1) * 1000
    assert d.max() < deg and t.max() < mm, (d, t)


def test_icp_pipeline_matches_jax(scene):
    """The phased pipeline with the ICP stage in both packages (seeded JAX
    weights carried across; SO(3) grid 16, 2 iterations, 3 hypotheses)."""
    from megapose6d_tpu.data import ObservationTensor as JObservation
    from megapose6d_tpu.inference import InferenceConfig as JInferenceConfig
    from megapose6d_tpu.inference import PoseEstimator as JPoseEstimator
    from megapose6d_tpu.inference import make_detections as jmake_detections
    from megapose6d_tpu.inference.depth_refiner import ICPRefiner as JICPRefiner
    from megapose6d_tpu_torch.data.types import ObservationTensor
    from megapose6d_tpu_torch.inference.depth_refiner import ICPRefiner
    from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
    from megapose6d_tpu_torch.inference.types import InferenceConfig, make_detections

    obs, TCO_gt = scene
    cfg = dict(SO3_grid_size=16, n_refiner_iterations=2, n_pose_hypotheses=3, bsz_images=16,
               bsz_objects=8, max_detections=2, run_depth_refiner=True)
    jc, cp, tc = init_pair(jpp.make_coarse_config, tpp.make_coarse_config, 0)
    jr, rp, tr = init_pair(jpp.make_refiner_config, tpp.make_refiner_config, 1,
                           n_rendered_views=2, multiview_type="TCO+front_1view")
    jdb, tdb_ = db_pair()
    half = 130 * 0.04 / 0.46
    box = np.asarray([[64.0 - half, 48.0 - half, 64.0 + half, 48.0 + half]], np.float32)
    boxes = np.concatenate([box, box + 3.0])
    jest = JPoseEstimator(jc, cp, jr, rp, jdb, JInferenceConfig(**cfg), depth_refiner=JICPRefiner(jdb))
    jout, jx = jest.run_inference_pipeline(JObservation(images=obs, K=K[None]),
                                           jmake_detections(["cube", "cube"], boxes))
    test = PoseEstimator(tc, tr, tdb_, InferenceConfig(**cfg), device="cpu", depth_refiner=ICPRefiner(tdb_))
    tout, tx = test.run_inference_pipeline(ObservationTensor(T_(obs), T_(K[None])),
                                           make_detections(["cube", "cube"], boxes, device="cpu"))
    assert_poses_close(jx["refiner"]["TCO_refined"], tx["refiner"]["TCO_refined"].numpy())
    np.testing.assert_array_equal(jx["depth_refiner"]["valid"], tx["depth_refiner"]["valid"].numpy())
    assert bool(tx["depth_refiner"]["valid"].all())
    assert_poses_close(jout.poses, tout.poses.numpy())
    assert set(test.timing_) == {"coarse", "refiner", "scoring", "depth_refiner", "total"}
    # The depth stage changed the RGB poses.
    rgb = tx["refiner"]["TCO_refined"].numpy()[np.arange(2), tx["refiner"]["pose_logits"].argmax(1).numpy()]
    assert np.abs(tout.poses.numpy() - rgb).max() > 1e-4
    # Asked per call without an observation depth channel: refused.
    with pytest.raises(ValueError):
        test.run_inference_pipeline(ObservationTensor(T_(obs[..., :3]), T_(K[None])),
                                    make_detections(["cube"], box, device="cpu"))


def test_depth_stage_needs_a_depth_refiner():
    from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
    from megapose6d_tpu_torch.inference.types import InferenceConfig

    _, tdb_ = db_pair()
    coarse = tpp.PosePredictor(tpp.make_coarse_config(render_size=RENDER, backbone="resnet18"))
    refiner = tpp.PosePredictor(tpp.make_refiner_config(render_size=RENDER, backbone="resnet18"))
    with pytest.raises(ValueError):
        PoseEstimator(coarse, refiner, tdb_, InferenceConfig(run_depth_refiner=True), device="cpu")


@pytest.mark.parametrize("name", ["megapose-1.0-RGBD", "megapose-1.0-RGB-multi-hypothesis-icp"])
def test_load_named_model_rgbd_runs(scene, name):
    """The named configurations at their full width (resnet34, 240x320,
    f32 on the CPU, seeded weights), one tiny request on a depth frame."""
    from megapose6d_tpu_torch.data.types import ObservationTensor
    from megapose6d_tpu_torch.inference.depth_refiner import ICPRefiner
    from megapose6d_tpu_torch.inference.load_model import load_named_model
    from megapose6d_tpu_torch.inference.types import make_detections
    from megapose6d_tpu_torch.meshes import io as tio
    from megapose6d_tpu_torch.meshes import mesh_db as tdb

    objects = tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04))])
    est = load_named_model(name, objects, max_faces=64, device="cpu", SO3_grid_size=4,
                           n_refiner_iterations=1, n_pose_hypotheses=2, bsz_images=4, bsz_objects=4,
                           max_detections=1)
    r = est.refiner_model.cfg
    assert est.coarse_model.cfg.backbone == "resnet34" and r.render_size == (240, 320)
    assert r.compute_dtype == "float32" and r.n_rendered_views == 4
    if name.endswith("icp"):
        assert isinstance(est.depth_refiner, ICPRefiner) and est.cfg.run_depth_refiner
        assert r.n_inputs == 27 and est.cfg.n_pose_hypotheses == 2
    else:
        assert est.depth_refiner is None and r.n_inputs == 32
        assert r.depth_normalization_type == "tCR_scale_clamp_center"
    obs, _ = scene
    half = 130 * 0.04 / 0.46
    box = np.asarray([[64.0 - half, 48.0 - half, 64.0 + half, 48.0 + half]], np.float32)
    out, extra = est.run_inference_pipeline(ObservationTensor(T_(obs), T_(K[None])),
                                            make_detections(["cube"], box, device="cpu"))
    assert torch.isfinite(out.poses).all()
    assert ("depth_refiner" in est.timing_) == name.endswith("icp") == ("depth_refiner" in extra)


def test_load_named_model_teaserpp_choice():
    from megapose6d_tpu_torch.inference.depth_refiner import GNCRegistrationRefiner
    from megapose6d_tpu_torch.inference import load_model as lm
    from megapose6d_tpu_torch.meshes import io as tio
    from megapose6d_tpu_torch.meshes import mesh_db as tdb

    objects = tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04))])
    est = lm.load_named_model("megapose-1.0-RGB", objects, max_faces=64, device="cpu",
                              run_depth_refiner=True, depth_refiner="teaserpp")
    assert isinstance(est.depth_refiner, GNCRegistrationRefiner)


# ---------------------------------------------------------------------------
# scripts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def example_dir(tmp_path_factory, scene):
    """An example directory: a cube PLY in millimetres, rgb and 16-bit
    depth (mm) PNGs, the camera and the input box."""
    from PIL import Image
    from megapose6d_tpu.data.types import CameraData, ObjectData
    from megapose6d_tpu.meshes import make_cube

    d = tmp_path_factory.mktemp("example") / "cube_example"
    (d / "meshes" / "cube").mkdir(parents=True)
    (d / "inputs").mkdir()
    cube = make_cube(40.0)
    with open(d / "meshes" / "cube" / "cube.ply", "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {cube.n_vertices}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {cube.n_faces}\nproperty list uchar int vertex_indices\nend_header\n")
        for v in cube.vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in cube.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
    obs, _ = scene
    (d / "camera_data.json").write_text(CameraData(K=K.astype(np.float64), resolution=IMG).to_json())
    Image.fromarray((obs[0, ..., :3] * 255).astype(np.uint8)).save(d / "image_rgb.png")
    Image.fromarray(np.round(obs[0, ..., 3] * 1000).astype(np.uint16)).save(d / "image_depth.png")
    half = 130 * 0.04 / 0.46
    box = [64.0 - half, 48.0 - half, 64.0 + half, 48.0 + half]
    (d / "inputs" / "object_data.json").write_text(
        json.dumps([ObjectData(label="cube", bbox_modal=np.asarray(box)).to_json()]))
    return d


def test_load_observation_with_depth_matches_jax(example_dir):
    from megapose6d_tpu.scripts.run_inference_on_example import load_observation as jload
    from megapose6d_tpu_torch.scripts.run_inference_on_example import load_observation as tload

    for depth in (False, True):
        a, b = jload(example_dir, load_depth=depth), tload(example_dir, load_depth=depth, device="cpu")
        assert b.channels == (4 if depth else 3)
        np.testing.assert_array_equal(b.images.numpy(), a.images)
        np.testing.assert_array_equal(b.K.numpy(), a.K)
    assert abs(float(b.depth.max()) - 0.5) < 0.05 and float(b.depth.min()) == 0.0


def test_run_inference_on_example_depth(example_dir):
    from megapose6d_tpu_torch.scripts.run_inference_on_example import main

    out = main([str(example_dir), "--run-inference", "--depth", "--so3-grid-size", "8",
                "--n-refiner-iterations", "1", "--n-pose-hypotheses", "2", "--bsz-images", "8",
                "--device", "cpu"])
    data = json.loads(out.read_text())
    assert len(data) == 1 and data[0]["label"] == "cube"
    quat, trans = data[0]["TWO"]
    assert np.isfinite(quat).all() and np.isfinite(trans).all()
    np.testing.assert_allclose(np.linalg.norm(quat), 1.0, atol=1e-4)
    # --vis-outputs draws the estimates of --run-inference; alone it writes nothing (as the JAX CLI).
    assert main([str(example_dir), "--vis-outputs", "--device", "cpu"]) is None
    assert not (example_dir / "visualizations").exists()


def test_demo_world_mesh_db_matches_jax():
    """`demo_ar_baseline`'s meshes: the port reads the dataset's models/,
    the JAX script builds the textured cube and sphere procedurally."""
    from megapose6d_tpu.scripts.demo_synthetic_e2e import build_world
    from megapose6d_tpu_torch.scripts.demo_ar_baseline import world_mesh_db

    jdb, _ = build_world(return_objects=True, labels=("obj_000001", "obj_000002"))
    tdb_ = world_mesh_db(ROOT / "runs/ar_gnc/synthdemo", "cpu")
    assert tdb_.labels == tuple(jdb.labels)
    for k in ("faces", "face_valid", "has_tex", "textures", "sym_valid"):
        np.testing.assert_array_equal(getattr(tdb_, k).numpy(), np.asarray(getattr(jdb, k)), err_msg=k)
    for k, tol in (("vertices", 1e-6), ("points", 1e-6), ("normals", 1e-5), ("uvs", 1e-6),
                   ("colors", 1e-6), ("diameters", 1e-6), ("symmetries", 1e-6)):
        np.testing.assert_allclose(getattr(tdb_, k).numpy(), np.asarray(getattr(jdb, k)), atol=tol, err_msg=k)


def test_demo_ar_baseline_refuses_what_is_not_ported(tmp_path):
    """Everything of the JAX script is ported (a missing dataset is
    generated, `detector_dir` runs: `tests/test_torch_scene_gen.py`,
    `tests/test_torch_detector_eval.py`); what it refuses is what the JAX
    script refuses."""
    from megapose6d_tpu_torch.scripts import demo_ar_baseline as demo

    for bad in ("domain=shiny", "depth_refine=2", "world=other"):
        with pytest.raises(ValueError):
            demo.run(demo.parse_args([f"out_dir={tmp_path}", bad, "device=cpu"]))
    assert not any(tmp_path.iterdir())
    with pytest.raises(ValueError):
        demo.parse_args(["unknown=1"])


def test_run_eval_refuses_the_depth_stage(tmp_path):
    from megapose6d_tpu_torch.evaluation.eval_config import EvalConfig, apply_eval_overrides
    from megapose6d_tpu_torch.evaluation.evaluation import run_eval

    cfg = apply_eval_overrides(EvalConfig(), [
        "ds_name=synthdemo.bop19", "data_dir=runs/ar_gnc", f"save_dir={tmp_path}", "device=cpu",
        "inference.run_depth_refiner=true"])
    with pytest.raises(ValueError, match="depth"):
        run_eval(cfg)
