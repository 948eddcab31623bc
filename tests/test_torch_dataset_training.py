"""Dataset-fed training on the CPU, tiny: `run_training train_datasets=`
and the port reading its own runs back.

  - `run_training train_datasets=synthdemo.bop19 data_dir=runs/ar_dr`
    (the committed BOP tree, 240x320 frames cropped and resized to 48x64,
    resnet18, the synthdemo models decimated to 128 faces) for 2 steps,
    then resumed for 1 more: the resumed run's log equals an unbroken
    3-step run's (the loader replays the stream's batches, and the draws
    follow the step). With 2 loader workers it also trains.
  - The first batch of that stream through the JAX package's
    `forward_loss` (its params carried across, its draws given to the
    port): the loss and metrics to rtol 1e-5, as in
    `tests/test_torch_forward_loss.py`. The batch itself is the JAX
    package's `PoseBatchFactory` batch, bit for bit.
  - `build_model` on the run directories loads the latest checkpoint
    (not seeded weights), and `run_eval` evaluates a port-trained coarse
    and refiner pair on one synthdemo frame; then with a detector trained
    by `run_detector_training` (`detector_run=`), whose weights
    `load_detector` reads from its checkpoint.
"""

import json
import logging
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.data.datasets_cfg import make_object_dataset as j_make_object_dataset
from megapose6d_tpu.data.loader import PoseBatchFactory as JPoseBatchFactory
from megapose6d_tpu.meshes.mesh_db import MeshDataBase as JMeshDataBase
from megapose6d_tpu.training.forward_loss import BatchPoseData as JBatchPoseData
from megapose6d_tpu.training.forward_loss import forward_loss as j_forward_loss
from megapose6d_tpu_torch.evaluation.evaluation import load_detector
from megapose6d_tpu_torch.inference.load_model import build_model, run_checkpoint
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.scripts import run_detector_training, run_eval, run_training
from megapose6d_tpu_torch.training.config import load_config
from megapose6d_tpu_torch.training.forward_loss import forward_loss
from tests.torch_training_refs import init_jax_model, jax_forward_loss_draws, jcfg

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "runs/ar_dr"
TINY = ["train_datasets=synthdemo.bop19", f"data_dir={DATA}", "epoch_size=2", "batch_size=2", "input_resize=48,64",
        "render_size=32,48", "n_rendered_views=1", "multiview_type=front_1view", "n_points_loss=32",
        "max_faces=128", "n_points_mesh=64", "save_epoch_interval=1", "backbone_str=resnet18", "min_area=10",
        "n_dataloader_workers=0", "device=cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("runs")
    common = TINY + [f"run_dir={d}"]
    run_training.main(["config_id=refiner", *common, "run_id=refiner", "n_epochs=2"])
    run_training.main(["config_id=refiner", *common, "run_id=refiner", "n_epochs=3", "resume_run_id=refiner"])
    run_training.main(["config_id=refiner", *common, "run_id=unbroken", "n_epochs=3"])
    run_training.main(["config_id=coarse", *common, "run_id=coarse", "n_epochs=1", "n_hypotheses=2"])
    return d


def _log(run: Path) -> list[dict]:
    return [json.loads(l) for l in (run / "log.txt").read_text().splitlines()]


def test_dataset_training_resumes_as_unbroken(runs):
    resumed, unbroken = _log(runs / "refiner"), _log(runs / "unbroken")
    assert [l["epoch"] for l in resumed] == [1, 2, 3] == [l["epoch"] for l in unbroken]
    drop = {"time_per_epoch"}
    assert [{k: v for k, v in l.items() if k not in drop} for l in resumed] == \
        [{k: v for k, v in l.items() if k not in drop} for l in unbroken]
    assert all(np.isfinite(l["loss_total"]) and "val_loss" not in l for l in resumed)
    assert (runs / "refiner/checkpoints/latest.txt").read_text() == "3"
    assert np.isfinite(_log(runs / "coarse")[0]["loss_total"])


def test_dataset_training_with_loader_workers(tmp_path):
    state = run_training.main(["config_id=refiner", *TINY, f"run_dir={tmp_path}", "run_id=w", "n_epochs=2",
                               "n_dataloader_workers=2"])
    assert state.step == 2 and all(np.isfinite(l["loss_total"]) for l in _log(tmp_path / "w"))


def test_first_batch_loss_matches_jax():
    """The stream's first batch (2 samples at 60x80, the size of
    `tests/torch_training_refs.py`) through both packages' forward_loss,
    from the same params and draws, in float32."""
    pin_f32()
    cfg = run_training.make_config("refiner", False, [a for a in TINY if a.split("=")[0] not in
                                                      ("train_datasets", "data_dir", "device")]
                                   + ["train_datasets=synthdemo.bop19", "compute_dtype=float32",
                                      "input_resize=60,80", "n_iterations=2"])
    tdb = run_training.dataset_mesh_db(cfg, "synthdemo.bop19", str(DATA), "cpu")
    jobjs = j_make_object_dataset("synthdemo.bop19", data_dir=DATA)
    jdb = JMeshDataBase.from_object_ds(jobjs, max_faces=cfg.max_faces, n_points=cfg.n_points_mesh,
                                       n_sym=cfg.n_sym).batched()
    np.testing.assert_array_equal(np.asarray(jdb.vertices), tdb.vertices.numpy())
    loader = run_training.dataset_loader(cfg, list(tdb.labels), str(DATA), "cpu")
    tb = next(loader)
    loader.close()
    kw = dict(dataset_names=("synthdemo.bop19",), labels=tuple(tdb.labels), batch_size=2, resize=(60, 80),
              min_area=10.0, data_dir=str(DATA))
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    jb_np = next(JPoseBatchFactory(**kw)(cfg.seed))
    for k in ("rgbs", "K", "TCO", "bboxes"):
        np.testing.assert_array_equal(np.asarray(getattr(jb_np, k)), getattr(tb, k).numpy(), err_msg=k)
    jb = JBatchPoseData(rgbs=jnp.asarray(jb_np.rgbs), K=jnp.asarray(jb_np.K), TCO=jnp.asarray(jb_np.TCO),
                        bboxes=jnp.asarray(jb_np.bboxes), mesh_idx=jnp.asarray(jb_np.mesh_idx))
    jmodel, params = init_jax_model(cfg, jdb, seed=4)
    key = jax.random.PRNGKey(11)
    with jax.default_matmul_precision("highest"):
        jloss, jmetrics = jax.jit(lambda p: j_forward_loss(p, jmodel, jcfg(cfg), jb, jdb, key, cfg.n_iterations))(
            params)
    tmodel = PosePredictor(PosePredictorConfig(**cfg.model_config_kwargs()))
    tmodel.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    draws = jax_forward_loss_draws(key, cfg, 2, tdb.points.shape[1])
    tloss, tmetrics = forward_loss(tmodel, cfg, tb, tdb, draws, cfg.n_iterations)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)


def test_build_model_reads_the_port_run(runs, caplog):
    ckpt = run_checkpoint(runs / "refiner")
    assert ckpt == runs / "refiner/checkpoints/epoch_3/state.pt"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
    with caplog.at_level(logging.WARNING):
        model = build_model(runs / "refiner", None, None, device="cpu")
    assert "drawn from seed" not in caplog.text
    for n, p in model.named_parameters():
        assert torch.equal(p, saved[n]), n
    named = build_model(runs / "refiner", runs / "refiner/checkpoints/epoch_1", None, device="cpu")
    first = torch.load(runs / "refiner/checkpoints/epoch_1/state.pt", weights_only=True)["params"]
    assert all(torch.equal(p, first[n]) for n, p in named.named_parameters())
    assert load_config(runs / "refiner/config.json").train_datasets == ("synthdemo.bop19",)


def test_run_eval_of_port_trained_models_and_detector(runs, tmp_path, caplog):
    argv = ["ds_name=synthdemo.bop19", f"data_dir={DATA}", f"coarse_run={runs / 'coarse'}",
            f"refiner_run={runs / 'refiner'}", "n_frames=1", "inference.SO3_grid_size=8",
            "inference.n_pose_hypotheses=1", "inference.n_refiner_iterations=1", "max_faces=128", "device=cpu"]
    with caplog.at_level(logging.WARNING):
        summary = run_eval.main(argv + [f"save_dir={tmp_path / 'gt'}"])
    assert "drawn from seed" not in caplog.text
    assert summary["bop"]["n"] > 0 and np.isfinite(summary["bop"]["AR"])

    det_dir = tmp_path / "det_runs"
    run_detector_training.main([f"run_dir={det_dir}", "run_id=det", "n_steps=3", "batch_size=2",
                                "resolution=64,96", "width=16", "demo_world=1", "device=cpu", "ckpt_every=2"])
    detector = load_detector(det_dir / "det", device="cpu")
    saved = torch.load(run_checkpoint(det_dir / "det"), map_location="cpu", weights_only=True)["params"]
    assert all(torch.equal(p, saved[n]) for n, p in detector.model.named_parameters())
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        summary = run_eval.main(argv + [f"save_dir={tmp_path / 'det'}", "inference.detection_type=detector",
                                        f"detector_run={det_dir / 'det'}"])
    assert "drawn from" not in caplog.text
    # Three detector steps find little: the AR is finite, the ground truth counted.
    assert summary["bop"]["n"] > 0 and np.isfinite(summary["bop"]["AR"])
    assert (tmp_path / "det/synthdemo.bop19/detector+SO3_grid/results.npz").exists()
