"""Port vs JAX: detector-driven evaluation and serving.

- The committed detector-driven evaluations
  (`runs/full_eval/synthdemo{,_unlit}.bop19/detector+SO3_grid`, 9 and 27
  ground-truth instances missed by the detector) rescored by the port's
  meters (`run_eval`, `skip_inference`), misses included, against the
  committed `summary.json` (scored on a TPU): the counts and the other
  recalls equal, the medians and the mean ADD within 1e-6 relative
  (float32 sums in another order), AR_VSD within one (instance, tau,
  theta) pair of VSD (0.189541 against 0.189450 and 0.106514 against
  0.106422, 1/10900), a pair in which the JAX package's own meters on a
  CPU differ from the TPU's as the port's do (`python -m
  tests.test_torch_detector_eval jax-rescore <ds>` prints the JAX
  package's rescoring of a whole set; ~4 min each).
- Two frames of those results (scene 2's views 10 and 11; view 11 holds a
  missed instance in both sets) rescored by both packages' meters in the
  test: every count and recall equal, the medians and the mean ADD within
  1e-6 relative.
- `PredictionRunner(detection_type="detector")` and
  `run_inference_pipeline(run_detector=True)` against the JAX package's on
  one frame of a small BOP set (96x128, the demo world), with seeded
  models carried across (the `tests/test_torch_pose_estimator.py` setup:
  grid 16, 2 refiner iterations, 3 hypotheses, 48x64 renders) and a seeded
  detector: the same detections (labels, scores within 1e-6, boxes within
  1e-3 px), and poses within 0.1 degree and 0.1 mm, at least half of them
  within 0.001 degree and 1e-5 of their distance (the seeded detector's
  boxes are a few pixels wide, so the objects sit metres away, where
  float32 rounds translations to ~10 um).
- `run_full_eval` with both detection types: `all_summaries.json` with the
  committed file's keys and layout, beside the JAX sweep's.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megapose6d_tpu.config as jconfig
from megapose6d_tpu.data.bop_scene_dataset import BOPDataset as JBOPDataset
from megapose6d_tpu.data import ObservationTensor as JObservation
from megapose6d_tpu.evaluation.eval_config import EvalConfig as JEvalConfig
from megapose6d_tpu.evaluation.eval_config import FullEvalConfig as JFullEvalConfig
from megapose6d_tpu.evaluation.evaluation import run_eval as jrun_eval
from megapose6d_tpu.evaluation.runner import PredictionRunner as JPredictionRunner
from megapose6d_tpu.inference import InferenceConfig as JInferenceConfig
from megapose6d_tpu.inference import PoseEstimator as JPoseEstimator
from megapose6d_tpu.meshes.mesh_db import MeshDataBase as JMeshDataBase
from megapose6d_tpu.models import detector as jdet
from megapose6d_tpu.models import pose_predictor as jpp
from megapose6d_tpu.scripts import demo_ar_baseline as jdemo
from megapose6d_tpu.scripts import run_inference_on_example as jexample
from megapose6d_tpu.scripts.run_full_eval import run_full_eval as jrun_full_eval
from megapose6d_tpu_torch.data.bop_scene_dataset import BOPDataset
from megapose6d_tpu_torch.data.types import ObservationTensor
from megapose6d_tpu_torch.evaluation.eval_config import EvalConfig, FullEvalConfig, get_save_dir
from megapose6d_tpu_torch.evaluation.evaluation import load_predictions, run_eval, save_predictions
from megapose6d_tpu_torch.evaluation.runner import PredictionRunner
from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
from megapose6d_tpu_torch.inference.types import InferenceConfig
from megapose6d_tpu_torch.interop.from_jax import detector_state_dict_from_jax, state_dict_from_jax
from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase
from megapose6d_tpu_torch.meshes.worlds import build_bop_world
from megapose6d_tpu_torch.models import detector as tdet
from megapose6d_tpu_torch.models import pose_predictor as tpp
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.scripts import run_full_eval
from megapose6d_tpu_torch.scripts.generate_synthetic_dataset import generate_bop
from tests.test_torch_pose_estimator import rot_deg

pin_f32()
ROOT = Path(__file__).resolve().parents[1]
FULL_EVAL = ROOT / "runs/full_eval"
RENDER = (48, 64)
CFG = dict(SO3_grid_size=16, n_refiner_iterations=2, n_pose_hypotheses=3, bsz_images=16, bsz_objects=8,
           max_detections=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The meters' many small ops gain nothing from threads and slow down
    when the test workers' pools contend (`tests/test_torch_eval.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EXACT = ("n", "n_missed", "ADD_0.1d", "5deg_5cm", "proj2d_5px", "AR_MSSD", "AR_MSPD", "AR_VSD", "AR")
VSD_PAIR = 1 / (109 * 100)  # one (instance, tau, theta) of AR_VSD's grid
SUBSET = {("2", 10), ("2", 11)}  # frames (scene, view) of the two-package rescoring


def rescore(ds: str, save_dir: Path, make_cfg, run, frames: set | None = None) -> dict:
    """The committed results of `ds` (only those of `frames`, if given)
    scored by `run(make_cfg(...))`."""
    committed = FULL_EVAL / f"{ds}.bop19" / "detector+SO3_grid"
    cfg = make_cfg(ds_name=f"{ds}.bop19", save_dir=str(save_dir), skip_inference=True, load_depth=True)
    get_save_dir(cfg).mkdir(parents=True)
    if frames is None:
        for f in ("results.npz", "results.json"):
            shutil.copy(committed / f, get_save_dir(cfg) / f)
    else:
        final = load_predictions(committed / "results.npz")["final"]
        rows = zip(final.infos["scene_id"].tolist(), final.infos["view_id"].tolist())
        keep = [i for i, (scene, view) in enumerate(rows) if (str(int(scene)), int(view)) in frames]
        save_predictions({"final": final[keep]}, get_save_dir(cfg) / "results")
    return run(cfg)["summary"]


def port_cfg(**kw) -> EvalConfig:
    return EvalConfig(data_dir=str(ROOT / "runs/ar_dr"), device="cpu",
                      inference=InferenceConfig(detection_type="detector"), **kw)


@pytest.mark.parametrize("ds", ["synthdemo", "synthdemo_unlit"])
def test_committed_detector_summary_reproduced(ds, tmp_path):
    summary = rescore(ds, tmp_path, port_cfg, run_eval)
    want = json.loads((FULL_EVAL / f"{ds}.bop19" / "detector+SO3_grid" / "summary.json").read_text())
    assert summary["modelnet"]["n_missed"] == want["modelnet"]["n_missed"] == {"synthdemo": 9, "synthdemo_unlit": 27}[ds]
    for meter in ("modelnet", "bop"):
        assert set(summary[meter]) == set(want[meter]), meter
        for k, v in summary[meter].items():
            if k in ("AR_VSD", "AR"):
                assert abs(v - want[meter][k]) <= VSD_PAIR / (3 if k == "AR" else 1) * 1.0001, (k, v, want[meter][k])
            elif k in EXACT:
                assert v == want[meter][k], (meter, k, v, want[meter][k])
            else:
                assert abs(v - want[meter][k]) <= 1e-6 * abs(want[meter][k]), (meter, k, v, want[meter][k])


@pytest.mark.parametrize("ds", ["synthdemo", "synthdemo_unlit"])
def test_committed_detector_frames_rescored_as_jax(ds, tmp_path, monkeypatch):
    monkeypatch.setattr(jconfig, "BOP_DS_DIR", ROOT / "runs/ar_dr")  # the JAX package's datasets_cfg reads it
    # A rescoring JAX run_eval keeps only the mesh database of its
    # `load_or_init_models`: skip the initialisation of the models it drops.
    monkeypatch.setattr(jexample, "load_or_init_models", lambda object_ds, *a, max_faces=4096, **kw: (
        None, None, None, None, JMeshDataBase.from_object_ds(object_ds, max_faces=max_faces).batched()))
    got = rescore(ds, tmp_path / "port", port_cfg, run_eval, SUBSET)
    want = rescore(ds, tmp_path / "jax", lambda **kw: JEvalConfig(
        inference=JInferenceConfig(detection_type="detector"), **kw), jrun_eval, SUBSET)
    assert got["modelnet"]["n_missed"] >= 1 and got["modelnet"]["n"] == 4
    for meter in ("modelnet", "bop"):
        assert set(got[meter]) == set(want[meter]), meter
        for k, v in got[meter].items():
            w = float(want[meter][k])
            assert v == w if k in EXACT else abs(v - w) <= 1e-6 * abs(w), (meter, k, v, w)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A one-frame BOP set of the demo world, seeded pose models and a
    seeded detector in both packages."""
    root = tmp_path_factory.mktemp("det_eval")
    tdb, tobjs = build_bop_world("demo", device="cpu")
    generate_bop(tdb, tobjs, root / "ds", n_frames=1, resolution=(96, 128), n_obj_per_scene=2, f=120.0,
                 frames_per_scene=4, seed=3)
    jdb, _ = jdemo.build_bop_world("demo")
    jscene, tscene = JBOPDataset(root / "ds"), BOPDataset(root / "ds")
    obs = tscene[0]
    K = obs.camera_data.K.astype(np.float32)
    m1 = jdb.select(jnp.zeros((1,), jnp.int32))
    models = {}
    for name, make_j, make_t, seed, kw in [
        ("coarse", jpp.make_coarse_config, tpp.make_coarse_config, 0, {}),
        ("refiner", jpp.make_refiner_config, tpp.make_refiner_config, 1,
         dict(n_rendered_views=2, multiview_type="TCO+front_1view")),
    ]:
        jm = jpp.PosePredictor(make_j(render_size=RENDER, backbone="resnet18", **kw))
        with jpp.skip_render_for_init():
            params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 96, 128, 3)), jnp.asarray(K)[None],
                                      jnp.eye(4)[None].at[0, 2, 3].set(0.5), m1)
        tm = tpp.PosePredictor(make_t(render_size=RENDER, backbone="resnet18", **kw))
        tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
        models[name] = (jm, params, tm)
    dcfg = jdet.DetectorConfig(n_classes=2, width=16, max_detections=8, predict_masks=True)
    jdm = jdet.CenterNetDetector(dcfg)
    dparams = jax.jit(jdm.init)(jax.random.PRNGKey(2), jnp.zeros((1, 96, 128, 3)))
    tdm = tdet.CenterNetDetector(tdet.DetectorConfig(n_classes=2, width=16, max_detections=8, predict_masks=True))
    tdm.load_state_dict(detector_state_dict_from_jax(jax.tree.map(np.asarray, dparams)))
    labels = list(tdb.labels)
    jdetector, tdetector = jdet.Detector(jdm, dparams, labels, 0.3), tdet.Detector(tdm, labels, 0.3)
    jest = JPoseEstimator(models["coarse"][0], models["coarse"][1], models["refiner"][0], models["refiner"][1], jdb,
                          JInferenceConfig(detection_type="detector", **CFG), detector=jdetector)
    test = PoseEstimator(models["coarse"][2], models["refiner"][2], tdb,
                         InferenceConfig(detection_type="detector", **CFG), device="cpu", detector=tdetector)
    return dict(root=root, jscene=jscene, tscene=tscene, jest=jest, test=test, jdetector=jdetector,
                tdetector=tdetector, K=K)


def assert_poses_close(a, b):
    a, b = np.asarray(a), b.numpy()
    deg = rot_deg(a[..., :3, :3], b[..., :3, :3])
    dt = np.linalg.norm(a[..., :3, 3] - b[..., :3, 3], axis=-1)
    assert deg.max() < 0.1 and dt.max() < 1e-4, (deg, dt)
    assert ((deg < 1e-3) & (dt < 1e-5 * np.linalg.norm(a[..., :3, 3], axis=-1))).mean() >= 0.5, (deg, dt)


def assert_same_detections(t_infos, t_boxes, j_infos, j_boxes):
    assert list(t_infos["label"]) == list(j_infos["label"])
    np.testing.assert_allclose(np.asarray(t_infos["score"], np.float64), j_infos["score"].to_numpy(), atol=1e-6)
    np.testing.assert_allclose(t_boxes, j_boxes, atol=1e-3)


def test_prediction_runner_detector_matches_jax(setup):
    jpred = JPredictionRunner(setup["jscene"], setup["jest"], detector=setup["jdetector"],
                              detection_type="detector").get_predictions()
    tpred = PredictionRunner(setup["tscene"], setup["test"], detector=setup["tdetector"],
                             detection_type="detector").get_predictions()
    assert set(tpred) == set(jpred) and len(tpred["final"]) == len(jpred["final"]) == 2
    for key in jpred:
        assert list(tpred[key].infos["label"]) == list(jpred[key].infos["label"]), key
        assert_poses_close(jpred[key].poses, tpred[key].poses)
    np.testing.assert_allclose(tpred["final"].infos["score"], jpred["final"].infos["score"].to_numpy(), atol=1e-6)


def test_run_inference_pipeline_run_detector_matches_jax(setup):
    img = (setup["tscene"][0].rgb.astype(np.float32) / 255.0)[None]
    jobs = JObservation(images=img, K=setup["K"][None])
    tobs = ObservationTensor(torch.as_tensor(img), torch.as_tensor(setup["K"][None]))
    jd, td = setup["jdetector"].get_detections(jobs), setup["tdetector"].get_detections(tobs)
    assert_same_detections(td.infos, td.bboxes.numpy(), jd.infos, np.asarray(jd.bboxes))
    jout, _ = setup["jest"].run_inference_pipeline(jobs, run_detector=True)
    tout, textra = setup["test"].run_inference_pipeline(tobs, run_detector=True)
    assert len(tout) == len(jout) == 2  # the two highest-scoring detections
    assert list(tout.infos["label"]) == list(jout.infos["label"])
    np.testing.assert_allclose(tout.infos["score"], jout.infos["score"].to_numpy(), atol=1e-6)
    assert_poses_close(jout.poses, tout.poses)
    assert "detector" in textra["timing"]


def test_run_full_eval_layout(setup, tmp_path):
    """The sweep through both detection types (1 frame, grid 8, seeded
    models at the committed runs' configurations and the committed
    detector's), and the JAX sweep's listing of committed results."""
    argv = ["ds_names=synthdemo.bop19", f"data_dir={ROOT / 'runs/ar_dr'}", f"save_dir={tmp_path / 'port'}",
            "detection_coarse_types=gt:SO3_grid,detector:SO3_grid", "coarse_run=runs/coarse_dr",
            "refiner_run=runs/refiner_dr", "detector_run=runs/detector_long", "load_depth=true", "n_frames=1",
            "inference.SO3_grid_size=8", "inference.n_pose_hypotheses=1", "inference.n_refiner_iterations=1",
            "inference.max_detections=2", "device=cpu"]
    summaries = run_full_eval.main(argv)
    committed = json.loads((FULL_EVAL / "all_summaries.json").read_text())
    keys = ["synthdemo.bop19/gt+SO3_grid", "synthdemo.bop19/detector+SO3_grid"]
    assert list(summaries) == keys
    assert json.loads((tmp_path / "port/all_summaries.json").read_text()) == json.loads(json.dumps(summaries))
    for k in keys:
        assert {m: set(v) for m, v in summaries[k].items()} == {m: set(v) for m, v in committed[k].items()}
        cfg = json.loads((tmp_path / "port" / k / "eval_config.json").read_text())
        assert cfg["inference"]["detection_type"] == k.split("/")[1].split("+")[0]
        assert cfg["detector_run"] == "runs/detector_long"
    # The JAX sweep over the committed results, listed (skip_inference), and the port's.
    for name in ("jax", "port_listed"):
        for k in keys:
            shutil.copytree(FULL_EVAL / k, tmp_path / name / k)
    jrun_full_eval(JFullEvalConfig(ds_names=["synthdemo.bop19"], save_dir=str(tmp_path / "jax"), skip_inference=True,
                                   detector_run="runs/detector_long",
                                   detection_coarse_types=[("gt", "SO3_grid"), ("detector", "SO3_grid")]))
    run_full_eval.run_full_eval(FullEvalConfig(
        ds_names=["synthdemo.bop19"], save_dir=str(tmp_path / "port_listed"), skip_inference=True,
        detector_run="runs/detector_long", detection_coarse_types=[("gt", "SO3_grid"), ("detector", "SO3_grid")]))
    assert (json.loads((tmp_path / "port_listed/all_summaries.json").read_text())
            == json.loads((tmp_path / "jax/all_summaries.json").read_text()) == {k: {} for k in keys})


if __name__ == "__main__":
    import sys
    import tempfile

    if len(sys.argv) != 3 or sys.argv[1] != "jax-rescore":
        sys.exit("usage: python -m tests.test_torch_detector_eval jax-rescore <synthdemo|synthdemo_unlit>")
    jax.config.update("jax_platforms", "cpu")
    jconfig.BOP_DS_DIR = ROOT / "runs/ar_dr"  # holds the committed synthdemo sets
    with tempfile.TemporaryDirectory() as tmp:
        out = rescore(sys.argv[2], Path(tmp), lambda **kw: JEvalConfig(
            inference=JInferenceConfig(detection_type="detector"), **kw), jrun_eval)
    print(json.dumps(out, default=float))
