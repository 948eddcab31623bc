"""Port vs JAX: the committed trained checkpoints in the port.

`export_params` reads a run's checkpoint with the JAX package's own
`load_checkpoint` and writes its params as an npz of `/`-joined keys, the
file `megapose6d_tpu_torch.inference.load_model` loads (the port cannot
read orbax). Also runnable as

    python -m tests.test_torch_checkpoints export runs/coarse_dr build/weights/coarse_dr.npz

The trained pipeline (`runs/coarse_dr` + `runs/refiner_dr`, f32, at the
240x320 that their spatial heads fix, SO(3) grid 72) runs in both packages
on committed frames of `runs/ar_dr/synthdemo` (read by the port's PNG
decoder, boxes from `scene_gt_info.json` `bbox_visib`, textured models).
Tolerances: the top-K ids equal; coarse logits within 0.05 and 90% of them
within 1e-3 (a silhouette pixel flipped by the last-bit differences of the
two packages' geometry moves a logit by ~1e-2, as
`tests/test_torch_pose_estimator.py` records); refined and final poses
within 0.1 degree and 0.1 mm.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":  # run as a script: keep JAX on the CPU
    os.environ["JAX_PLATFORMS"] = "cpu"

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RUNS = ROOT / "runs"
SCENE = RUNS / "ar_dr/synthdemo"


def jax_params(run_dir: str | Path, compute_dtype: str | None = None):
    """(JAX model, its params as numpy) of a committed run, through the
    JAX package's own `load_checkpoint`."""
    from megapose6d_tpu.meshes import MeshDataBase, RigidObject, RigidObjectDataset, make_cube
    from megapose6d_tpu.models import pose_predictor as jpp
    from megapose6d_tpu.training.config import load_config
    from megapose6d_tpu.training.train import TrainState, load_checkpoint

    run_dir = Path(run_dir)
    jcfg = load_config(run_dir / "config.json")
    kw = jcfg.model_config_kwargs()
    if compute_dtype is not None:
        kw["compute_dtype"] = compute_dtype
    jmodel = jpp.PosePredictor(jpp.PosePredictorConfig(**kw))
    tiny = MeshDataBase.from_object_ds(
        RigidObjectDataset([RigidObject(label="cube", mesh=make_cube(0.04))]),
        max_faces=64, n_points=16, n_sym=2).batched(align=16)
    with jpp.skip_render_for_init():  # the restore target: shapes only
        target = jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), jnp.zeros((1,) + tuple(jcfg.input_resize) + (3,)),
            jnp.eye(3)[None] * 100.0, jnp.eye(4)[None].at[0, 2, 3].set(0.5),
            tiny.select(jnp.zeros((1,), jnp.int32)))
    state = TrainState.create(apply_fn=jmodel.apply, params=target, tx=optax.identity())
    state, _ = load_checkpoint(run_dir, state, params_only=True)
    return jmodel, jax.tree.map(np.asarray, state.params)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def export_params(run_dir: str | Path, out: str | Path) -> Path:
    """Write a run's params as an npz of `/`-joined keys."""
    _, params = jax_params(run_dir)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flatten(params))
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Both runs exported once: {run: (JAX model, params, npz path)}."""
    d = tmp_path_factory.mktemp("weights")
    out = {}
    for run in ("coarse_dr", "refiner_dr"):
        jmodel, params = jax_params(RUNS / run, compute_dtype="float32")
        path = d / f"{run}.npz"
        np.savez(path, **flatten(params))
        out[run] = (jmodel, params, path)
    return out


def test_npz_round_trip_loads_the_checkpoint(exported):
    """The exported npz gives the state dict of the checkpoint's params,
    through `load_or_init_models`, with the runs' configurations."""
    from megapose6d_tpu_torch.data.bop_scene_dataset import load_bop_object_dataset
    from megapose6d_tpu_torch.inference.load_model import load_or_init_models, load_params_npz
    from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax

    params = exported["coarse_dr"][1]
    tree = load_params_npz(exported["coarse_dr"][2])
    assert flatten(tree).keys() == flatten(params).keys()
    coarse, refiner, db = load_or_init_models(
        load_bop_object_dataset(SCENE / "models"), RUNS / "coarse_dr", RUNS / "refiner_dr",
        exported["coarse_dr"][2], exported["refiner_dr"][2], device="cpu")
    for model, run in ((coarse, "coarse_dr"), (refiner, "refiner_dr")):
        expected = state_dict_from_jax(exported[run][1])
        got = model.state_dict()
        assert got.keys() == expected.keys()
        for k in expected:
            assert torch.equal(got[k], expected[k]), k
    assert refiner.cfg.n_rendered_views == 2 and coarse.cfg.compute_dtype == "bfloat16"
    assert db.has_tex.tolist() == [True, True] and db.labels == ("obj_000001", "obj_000002")


def test_seeded_models_without_npz():
    from megapose6d_tpu_torch.inference.load_model import build_model
    from megapose6d_tpu_torch.models.pose_predictor import make_coarse_config

    a = build_model(RUNS / "coarse_dr", None, make_coarse_config, seed=3, device="cpu")
    b = build_model(RUNS / "coarse_dr", None, make_coarse_config, seed=3, device="cpu")
    c = build_model(None, None, make_coarse_config, render_size=(48, 64), seed=3, device="cpu")
    assert a.cfg.backbone == "resnet18-spatial" and c.cfg.render_size == (48, 64)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


def frames(view_ids, n_det):
    """Committed frames of scene 000000: (rgb, K, labels, boxes)."""
    from megapose6d_tpu_torch.data.datasets_cfg import make_scene_dataset

    ds = make_scene_dataset("synthdemo.bop19", data_dir=SCENE.parent)
    out = []
    for i in view_ids:
        obs = ds[i]
        dets = obs.gt_detections()[:n_det]
        out.append((obs.rgb, obs.camera_data.K.astype(np.float32), [o.label for o in dets],
                    np.stack([o.bbox_modal for o in dets]).astype(np.float32)))
    return out


def run_pipelines(exported, view_ids, n_det, icfg):
    """The trained pipeline in both packages, f32, on the frames."""
    from megapose6d_tpu.data import ObservationTensor as JObservation
    from megapose6d_tpu.inference import InferenceConfig as JInferenceConfig
    from megapose6d_tpu.inference import PoseEstimator as JPoseEstimator
    from megapose6d_tpu.inference import make_detections as jmake_detections
    from megapose6d_tpu.meshes import MeshDataBase as JMeshDataBase
    from megapose6d_tpu.data.bop_scene_dataset import load_bop_object_dataset as jload_objects
    from megapose6d_tpu_torch.data.bop_scene_dataset import load_bop_object_dataset
    from megapose6d_tpu_torch.data.types import ObservationTensor
    from megapose6d_tpu_torch.inference.load_model import load_or_init_models
    from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
    from megapose6d_tpu_torch.inference.types import InferenceConfig, make_detections
    from megapose6d_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from megapose6d_tpu_torch.ops._precision import pin_f32

    pin_f32()
    (jc, cparams, cpath), (jr, rparams, rpath) = exported["coarse_dr"], exported["refiner_dr"]
    jdb = JMeshDataBase.from_object_ds(jload_objects(SCENE / "models")).batched()
    jest = JPoseEstimator(jc, cparams, jr, rparams, jdb, JInferenceConfig(**icfg))
    coarse, refiner, tdb = load_or_init_models(
        load_bop_object_dataset(SCENE / "models"), RUNS / "coarse_dr", RUNS / "refiner_dr",
        cpath, rpath, device="cpu")
    f32 = lambda m: PosePredictor(PosePredictorConfig(**{**m.cfg.__dict__, "compute_dtype": "float32"}))
    models = []
    for m in (coarse, refiner):
        m32 = f32(m)
        m32.load_state_dict(m.state_dict())
        models.append(m32.eval())
    test = PoseEstimator(*models, tdb, InferenceConfig(**icfg), device="cpu")
    out = []
    for rgb, K, labels, boxes in frames(view_ids, n_det):
        j = jest.run_inference_pipeline(
            JObservation.from_numpy(rgb, None, K), jmake_detections(labels, boxes))
        t = test.run_inference_pipeline(
            ObservationTensor.from_numpy(rgb, K, device="cpu"), make_detections(labels, boxes, device="cpu"))
        out.append((j, t))
    return out


def rot_deg(Ra, Rb):
    cos = (np.trace(np.swapaxes(Ra, -1, -2) @ Rb, axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def assert_poses_close(a, b):
    a, b = np.asarray(a), b.numpy()
    deg = rot_deg(a[..., :3, :3], b[..., :3, :3])
    mm = np.abs(a[..., :3, 3] - b[..., :3, 3]).max(-1) * 1000
    assert deg.max() < 0.1 and mm.max() < 0.1, (deg, mm)


def check_pipelines(results):
    for (jout, jx), (tout, tx) in results:
        assert tout.labels == list(jout.infos["label"])
        d = np.abs(np.asarray(jx["coarse"]["logits"]) - tx["coarse"]["logits"].numpy())
        assert d.max() < 0.05 and (d < 1e-3).mean() >= 0.9, (d.max(), (d < 1e-3).mean())
        np.testing.assert_array_equal(jx["coarse"]["top_ids"], tx["coarse"]["top_ids"].numpy())
        assert_poses_close(jx["refiner"]["trajectory"], tx["refiner"]["trajectory"])
        d = np.abs(np.asarray(jx["refiner"]["pose_logits"]) - tx["refiner"]["pose_logits"].numpy())
        assert d.max() < 0.05, d
        assert_poses_close(jout.poses, tout.poses)


def test_trained_pipeline_one_detection_matches_jax(exported):
    """One frame, one detection, one refiner iteration."""
    icfg = dict(SO3_grid_size=72, n_pose_hypotheses=2, n_refiner_iterations=1, bsz_images=72,
                bsz_objects=4, max_detections=1)
    check_pipelines(run_pipelines(exported, [0], 1, icfg))


@pytest.mark.slow
def test_trained_pipeline_frames_match_jax(exported):
    """Two frames, all their detections, two refiner iterations."""
    icfg = dict(SO3_grid_size=72, n_pose_hypotheses=3, n_refiner_iterations=2, bsz_images=72,
                bsz_objects=8, max_detections=2)
    check_pipelines(run_pipelines(exported, [0, 5], 2, icfg))


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "export":
        sys.exit("usage: python -m tests.test_torch_checkpoints export <run_dir> <out.npz>")
    print(export_params(sys.argv[2], sys.argv[3]))
