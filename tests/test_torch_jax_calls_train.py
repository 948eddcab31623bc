"""Calls written against the JAX package give the JAX results on the port:
the trainer's loop, `train`, in the JAX package's positional order.

Tolerances are stated in the test's docstring.
"""

from __future__ import annotations

import json

import jax
import pytest
import torch

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops gain nothing from threads and slow down many times
    over when the test workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_loop_matches_jax(tmp_path):
    """`train(cfg, model, mesh_db, batch_iterator, run_dir, n_epochs,
    steps_per_epoch, log_fn, input_res=, val_iterator=, n_val_batches=)`
    for 2 epochs of 1 step, as the JAX loop: the log's epochs, iteration
    counts and keys, the steps taken, the checkpoints and `config.json`
    in `run_dir`; and `create_train_state(cfg, model, mesh_db, ...)` on a
    given model."""
    from megapose6d_tpu.models.pose_predictor import PosePredictor as JPosePredictor
    from megapose6d_tpu.models.pose_predictor import PosePredictorConfig as JPosePredictorConfig
    from megapose6d_tpu.training.train import synthetic_batch_fn as jfn
    from megapose6d_tpu.training.train import train as jtrain
    from megapose6d_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
    from megapose6d_tpu_torch.training import train as tt
    from tests.test_torch_train import tiny_cfg
    from tests.torch_training_refs import INPUT, j_db, jcfg, t_db

    cfg = tiny_cfg(tmp_path, save_epoch_interval=2, val_epoch_interval=1)
    jdb, tdb = j_db(), t_db()
    jfn_ = jax.jit(jfn(jdb, cfg.batch_size, INPUT, 120.0))
    jbatches = (jfn_(jax.random.PRNGKey(i)) for i in range(100))
    jlogs, tlogs = [], []
    jstate = jtrain(jcfg(cfg), JPosePredictor(JPosePredictorConfig(**cfg.model_config_kwargs())), jdb, jbatches,
                    tmp_path / "jax", 2, 1, jlogs.append, None, INPUT,
                    (jfn_(jax.random.PRNGKey(1000 + i)) for i in range(100)), 1)
    synth = tt.synthetic_batch_fn(tdb, cfg.batch_size, INPUT, 120.0, device="cpu")
    tbatches = (synth(torch.Generator().manual_seed(i)) for i in range(100))
    model = PosePredictor(PosePredictorConfig(**cfg.model_config_kwargs()))
    tstate = tt.train(cfg, model, tdb, tbatches, tmp_path / "port", 2, 1, tlogs.append, INPUT,
                      (synth(torch.Generator().manual_seed(1000 + i)) for i in range(100)), 1)
    assert tstate.model is model and tstate.step == int(jstate.step) == 2
    assert [(l["epoch"], l["n_iterations"]) for l in tlogs] == [(l["epoch"], l["n_iterations"]) for l in jlogs] \
        == [(1, 1), (2, 1)]
    assert [set(l) for l in tlogs] == [set(l) for l in jlogs]
    for run in ("jax", "port"):
        assert (tmp_path / run / "config.json").is_file()
        assert [json.loads(l)["epoch"] for l in (tmp_path / run / "log.txt").read_text().splitlines()] == [1, 2]
    assert sorted(p.name for p in (tmp_path / "port/checkpoints").iterdir()) == ["epoch_2", "latest.txt"]
    assert (tmp_path / "jax/checkpoints/epoch_2").is_dir() and not (tmp_path / "jax/checkpoints/epoch_1").exists()
    fresh = tt.create_train_state(cfg, model, tdb, INPUT, device="cpu")
    assert fresh.model is model and fresh.step == 0 and fresh.opt_state["count"] == 0
