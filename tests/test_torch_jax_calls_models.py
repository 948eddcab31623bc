"""Calls written against the JAX package give the JAX results on the port:
the model-level entry points (the pipeline, the depth refiners, the
detector, the named models, the trainer, the dataset generator and the
tiled renderer), each fed the same seeded inputs through both packages.

Tolerances are stated per case; where a case repeats a comparison of
another test file at other arguments, it keeps that file's tolerance.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu_torch.ops._precision import pin_f32
from tests.test_torch_depth import refiner_inputs  # noqa: F401 (a fixture)
from tests.test_torch_depth import rot_deg
from tests.test_torch_scene_gen import dbs  # noqa: F401 (a fixture)

pin_f32()
ROOT = Path(__file__).resolve().parents[1]
RUNS = ROOT / "runs"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops gain nothing from threads and slow down many times
    over when the test workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def test_run_inference_pipeline_positional():
    """`PoseEstimator(coarse, refiner, mesh_db, cfg, depth_refiner)` binds
    the depth refiner as the JAX `PoseEstimator(coarse, cparams, refiner,
    rparams, mesh_db, cfg, depth_refiner)` does, and
    `run_inference_pipeline(obs, dets, False, 1, 2, True)` keeps all
    coarse outputs and runs no depth refiner on both. Poses and coarse
    hypotheses within `tests/test_torch_pose_estimator.py`'s tolerances
    (0.1 degree, 0.1 mm)."""
    from megapose6d_tpu.inference.depth_refiner import ICPRefiner as JICP
    from megapose6d_tpu_torch.inference.depth_refiner import ICPRefiner
    from tests.test_torch_pose_estimator import build_estimators

    jest, test, jargs, targs = build_estimators()
    j_icp, t_icp = JICP(jest.mesh_db), ICPRefiner(test.mesh_db)
    assert type(jest)(jest.coarse_model, jest.coarse_params, jest.refiner_model, jest.refiner_params,
                      jest.mesh_db, jest.cfg, j_icp).depth_refiner is j_icp
    assert type(test)(test.coarse_model, test.refiner_model, test.mesh_db, test.cfg, t_icp,
                      device="cpu").depth_refiner is t_icp
    jout, jextra = jest.run_inference_pipeline(*jargs, False, 1, 2, True)
    tout, textra = test.run_inference_pipeline(*targs, False, 1, 2, True)
    assert "depth_refiner" not in jextra and "depth_refiner" not in textra
    a, b = np.asarray(jextra["coarse"]["all_TCO"]), textra["coarse"]["all_TCO"].numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=1e-5)
    a, b = np.asarray(jout.poses), tout.poses.numpy()
    assert rot_deg(a[:, :3, :3], b[:, :3, :3]).max() < 0.1
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() * 1000 < 0.1


def test_refine_poses_positional_masks(refiner_inputs):  # noqa: F811
    """`refine_poses(predictions, masks, depth, K)`, masks not read in
    either package: ICP on frame 5 of runs/ar_gnc/synthdemo, the valid
    flags equal and the cubes' poses within 0.01 degree and 0.01 mm, the
    sphere's finite (`tests/test_torch_depth.py`'s tolerances: ICP cannot
    observe a sphere's rotation about its centre)."""
    import pandas as pd

    from megapose6d_tpu.data.tensor_collection import PandasTensorCollection
    from megapose6d_tpu.inference.depth_refiner import ICPRefiner as JICP
    from megapose6d_tpu_torch.data.tensor_collection import TensorCollection
    from megapose6d_tpu_torch.inference.depth_refiner import ICPRefiner
    from tests.test_torch_depth import SPHERE, T_

    jdb, tdb, frames = refiner_inputs
    depth, K, labels, poses = frames[1]
    masks = np.ones((len(labels),) + depth.shape, bool)
    jout, jx = JICP(jdb).refine_poses(PandasTensorCollection(pd.DataFrame({"label": labels}), poses=poses),
                                      masks, depth, K)
    tout, tx = ICPRefiner(tdb).refine_poses(TensorCollection(labels, poses=T_(poses)), masks, T_(depth), T_(K))
    np.testing.assert_array_equal(np.asarray(jx["valid"]), tx["valid"].numpy())
    a, b = np.asarray(jout.poses), tout.poses.numpy()
    tight = np.array([label != SPHERE for label in labels])
    assert tight.any() and np.isfinite(b).all()
    assert rot_deg(a[tight, :3, :3], b[tight, :3, :3]).max() < 0.01
    assert np.abs(a[tight, :3, 3] - b[tight, :3, 3]).max() * 1000 < 0.01


# ---------------------------------------------------------------------------
# The detector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("override", [None, False])
def test_detector_one_instance_per_class(override):
    """`Detector(model, labels, 0.0, True)` (the JAX one with its params
    second): one detection a class unless the call overrides it. Scores to
    1e-6, boxes to 1e-3 px (`tests/test_torch_detector.py`)."""
    from megapose6d_tpu.data.types import ObservationTensor as JObservation
    from megapose6d_tpu.models import detector as jdet
    from megapose6d_tpu_torch.data.types import ObservationTensor
    from megapose6d_tpu_torch.models import detector as tdet
    from tests.test_torch_detector import H, W, models

    jm, params, tm = models()
    img = np.random.RandomState(3).rand(1, H, W, 3).astype(np.float32)
    K = np.eye(3, dtype=np.float32)[None]
    labels = ["obj_a", "obj_b"]
    jd, td = jdet.Detector(jm, params, labels, 0.0, True), tdet.Detector(tm, labels, 0.0, True)
    kw = {} if override is None else dict(one_instance_per_class=override)
    j = jd.get_detections(JObservation(images=img, K=K), **kw)
    t = td.get_detections(ObservationTensor(torch.as_tensor(img), torch.as_tensor(K)), **kw)
    assert list(t.infos["label"]) == list(j.infos["label"])
    assert (len(t) <= 2) == (override is None) and len(t) > 0
    np.testing.assert_allclose(t.infos["score"], j.infos["score"].to_numpy(), atol=1e-6)
    np.testing.assert_allclose(t.bboxes.numpy(), np.asarray(j.bboxes), atol=1e-3)


def test_load_detector_detection_th():
    """`load_detector(run_dir, detection_th)` on the committed detector:
    the threshold is the detector's, and a frame's detections at 0.05 are
    the JAX package's (labels; scores to 1e-4: float32 convolutions in
    another order)."""
    from megapose6d_tpu.data.types import ObservationTensor as JObservation
    from megapose6d_tpu.evaluation.evaluation import load_detector as jload
    from megapose6d_tpu_torch.data.bop_scene_dataset import BOPDataset
    from megapose6d_tpu_torch.data.types import ObservationTensor
    from megapose6d_tpu_torch.evaluation.evaluation import load_detector

    jd, td = jload(RUNS / "detector_long", 0.05), load_detector(RUNS / "detector_long", 0.05, device="cpu")
    assert td.detection_th == jd.detection_th == 0.05
    frame = BOPDataset(RUNS / "ar_dr/synthdemo")[0]
    img = (frame.rgb.astype(np.float32) / 255.0)[None]
    K = frame.camera_data.K.astype(np.float32)[None]
    j = jd.get_detections(JObservation(images=img, K=K))
    t = td.get_detections(ObservationTensor(torch.as_tensor(img), torch.as_tensor(K)))
    assert len(t) == len(j) > 0 and list(t.infos["label"]) == list(j.infos["label"])
    np.testing.assert_allclose(t.infos["score"], j.infos["score"].to_numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def test_synthetic_batch_fn_z_range():
    """`synthetic_batch_fn(mesh_db, B, input_res, f, z_range)`: the JAX
    package's batch from its own draws (poses, boxes to 1e-4 as
    `tests/test_torch_train.py`), centres at depths inside the range, and
    the port's own draws inside it too."""
    from megapose6d_tpu.training.train import synthetic_batch_fn as jfn
    from megapose6d_tpu_torch.training import train as tt
    from tests.torch_training_refs import INPUT, j_db, jax_synthetic_draws, t_db

    jdb, tdb = j_db(), t_db()
    key, B, z_range = jax.random.PRNGKey(5), 4, (0.5, 0.6)
    jb = jax.jit(jfn(jdb, B, INPUT, 120.0, z_range, renderer="tiled"))(key)
    synth = tt.synthetic_batch_fn(tdb, B, INPUT, 120.0, z_range, device="cpu")
    tb = synth.make(jax_synthetic_draws(key, B, len(tdb.labels), z_range=z_range))
    for name in ("TCO", "K", "bboxes"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), atol=1e-4)
    own = synth(torch.Generator().manual_seed(0))
    for z in (tb.TCO[:, 2, 3], own.TCO[:, 2, 3]):
        assert bool(((z >= 0.5) & (z <= 0.6)).all()), z


# ---------------------------------------------------------------------------
# The dataset generator
# ---------------------------------------------------------------------------


def test_generate_bop_without_shadows_or_ibl(tmp_path, dbs):  # noqa: F811
    """`generate_bop(..., background, shadows=False, ibl=False)`, all
    positional, against the JAX package's at the same options (the frames
    to `tests/test_torch_scene_gen.py`'s tolerances), and unlike the port's
    frames with both on."""
    from megapose6d_tpu.scripts import generate_synthetic_dataset as jgen
    from megapose6d_tpu_torch.data.bop_scene_dataset import BOPDataset
    from megapose6d_tpu_torch.scripts import generate_synthetic_dataset as gen
    from tests.test_torch_scene_gen import RES, frames_equal

    jdb, tdb = dbs
    args = (2, RES, 2, 120.0, 2, 5, "test", False, True)
    gen.generate_bop(tdb, gen._default_objects(), tmp_path / "port", *args, False, False)
    jgen.generate_bop(jdb, jgen._default_objects(), tmp_path / "jax", *args, False, False)
    gen.generate_bop(tdb, gen._default_objects(), tmp_path / "lit", *args)
    port, jax_, lit = (BOPDataset(tmp_path / d, load_depth=True) for d in ("port", "jax", "lit"))
    assert len(port) == len(jax_) == 2
    for i in range(2):
        frames_equal(port[i], jax_[i])
    assert any(not np.array_equal(port[i].rgb, lit[i].rgb) for i in range(2))


# ---------------------------------------------------------------------------
# The tiled renderer's scheduling knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(chunk=32), dict(tile_h=16), dict(max_faces_per_program=96),
                                dict(chunk=32, tile_h=16, max_faces_per_program=96)],
                         ids=["chunk32", "tile_h16", "segments96", "all"])
def test_render_tiled_knobs_match_jax(kw):
    """The JAX package's `test_chunk_sizes_equivalent` and
    `test_face_segmentation_equivalence` inputs (a 12 x 16 UV sphere of 5
    cm at `pose_z(0.4, 0.7)`), rendered by both packages at the same
    options: masks equal, depth to 1e-6 at another chunk and 1e-3 in
    segments (the JAX tests' tolerances), rgb and normals to 1e-3; and the
    port's image at the options is its image at the defaults, bit for bit
    (the knobs schedule the TPU kernel only)."""
    from megapose6d_tpu.meshes import make_uv_sphere
    from tests.test_torch_rasterizer import mesh_args, pose_z, render_both

    args = mesh_args(make_uv_sphere(0.05, n_lat=12, n_lon=16), [pose_z(0.4, 0.7)])
    j, t = render_both(args, **kw)
    _, t_default = render_both(args)
    np.testing.assert_array_equal(t["mask"], j["mask"])
    atol = 1e-3 if "max_faces_per_program" in kw else 1e-6
    np.testing.assert_allclose(t["depth"], j["depth"], atol=atol, rtol=0)
    for name in ("rgb", "normals"):
        np.testing.assert_allclose(t[name], j[name], atol=1e-3, rtol=1e-3, err_msg=name)
    for name in t:
        np.testing.assert_array_equal(t[name], t_default[name], err_msg=name)


def test_pose_predictor_tile_face_chunk_32(rng):
    """`PosePredictorConfig(tile_face_chunk=32)` builds; the model scores
    the JAX model of that config (logits to 1e-4, renders to 1e-4, as
    `tests/test_torch_pose_predictor.py`) and its own twin at 16 bit for
    bit."""
    from megapose6d_tpu.models import pose_predictor as jpp
    from megapose6d_tpu_torch.models import pose_predictor as tpp
    from tests.test_torch_pose_predictor import close, init_both, japply, scene

    jm, params, tm, jdb, tdb = init_both(dict(tile_face_chunk=32), jpp.make_coarse_config, tpp.make_coarse_config, 0)
    assert tm.cfg.tile_face_chunk == jm.cfg.tile_face_chunk == 32
    t16 = tpp.PosePredictor(dataclasses.replace(tm.cfg, tile_face_chunk=16))
    t16.load_state_dict(tm.state_dict())
    img, K, TCO = scene(rng, 2)
    labels = ["cube", "sphere"]
    jout = japply(jm, params, jpp.PosePredictor.score_views, jnp.asarray(img), jnp.asarray(K), jnp.asarray(TCO),
                  jdb.select(jdb.label_to_index(labels)))
    with torch.no_grad():
        args = (torch.as_tensor(img), torch.as_tensor(K), torch.as_tensor(TCO), tdb.select(tdb.label_to_index(labels)))
        tout, out16 = tm.score_views(*args), t16.eval().score_views(*args)
    close(jout["renders"], tout["renders"], 1e-4)
    close(jout["logits"], tout["logits"], 1e-4)
    for k in tout:
        assert torch.equal(tout[k], out16[k]), k
