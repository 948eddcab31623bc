"""Port vs JAX: the trainer's schedule, optimizer and synthetic batches;
the port's checkpoints, resume and CLI.

- `make_lr_schedule` against the JAX package's at steps 0, warm-up - 1,
  warm-up and after a decay (rtol 1e-6: the JAX schedule computes in
  float32).
- Two Adam updates after clipping, against optax (the JAX package's
  `make_optimizer`) on the same params and grads, with the gradients'
  norm above and below `clip_grad_norm`, and as AdamW: atol 1e-7.
- `synthetic_batch_fn` against the JAX package's with `renderer="tiled"`,
  from the JAX package's own draws, plain, with `domain_rand` and
  `occlude` on, and on a textured mesh database (the checker quad of
  `tests/test_torch_textures.py`): poses, intrinsics and boxes to atol 1e-4 (pixels), rgb to
  atol 1e-4 except at silhouette-edge pixels, where the two packages'
  phase A rounds the last bit differently: at most 8 pixels of a batch
  may differ there (on these inputs none does).
- A checkpoint round trip, and pretraining from one and from an npz
  export of JAX params; a run resumed after 2 of 4 epochs ends with
  the parameters of an unbroken 4-epoch run, exactly; and
  `run_training ... synthetic=1` at a tiny size writes `log.txt` with the
  JAX package's keys and a checkpoint.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from megapose6d_tpu.training.train import make_lr_schedule as j_make_lr_schedule
from megapose6d_tpu.training.train import make_optimizer as j_make_optimizer
from megapose6d_tpu.training.train import synthetic_batch_fn as j_synthetic_batch_fn
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.scripts import run_training
from megapose6d_tpu_torch.training import train as tt
from megapose6d_tpu_torch.training.config import TrainingConfig, load_config
from tests.test_torch_textures import quad_dbs
from tests.torch_training_refs import INPUT, init_jax_model, j_db, jax_synthetic_draws, jcfg, t_db

JAX_LOG_KEYS = {"loss_total", "loss_TCO", "loss_TCO-loss_orn", "loss_TCO-loss_xy", "loss_TCO-loss_z",
                "grad_norm", "epoch", "n_iterations", "time_per_epoch", "val_loss"}
TINY = ["synthetic=1", "batch_size=2", "epoch_size=2", "input_resize=48,64", "render_size=32,48",
        "n_rendered_views=1", "multiview_type=front_1view", "n_points_loss=32", "max_faces=128",
        "n_points_mesh=64", "backbone_str=resnet18", "n_iterations=1", "device=cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny training runs gain little from more threads (the resume
    test takes 3.2 s on eight, 6.3 s on one) but slow down ~45x when the
    test workers' thread pools contend for the cores (141 s); one thread
    for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lr_schedule_matches_jax():
    cfg = TrainingConfig(lr=3e-4, n_epochs_warmup=3, lr_epoch_decay=5)
    spe = 4
    js, ts = j_make_lr_schedule(jcfg(cfg), spe), tt.make_lr_schedule(cfg, spe)
    warmup = cfg.n_epochs_warmup * spe
    for step in (0, warmup - 1, warmup, cfg.lr_epoch_decay * spe + 1):
        np.testing.assert_allclose(ts(step), float(js(jnp.asarray(step))), rtol=1e-6)
    assert ts(0) == pytest.approx(cfg.lr / warmup) and ts(warmup) == pytest.approx(cfg.lr)
    assert ts(cfg.lr_epoch_decay * spe + 1) == pytest.approx(cfg.lr * 0.1)


@pytest.mark.parametrize("grad_scale,weight_decay", [
    pytest.param(10.0, 0.0, id="clipped"), pytest.param(0.01, 0.0, id="unclipped"),
    pytest.param(10.0, 0.05, id="adamw"),
])
def test_adam_clip_matches_optax(rng, grad_scale, weight_decay):
    cfg = TrainingConfig(lr=1e-3, n_epochs_warmup=1, clip_grad_norm=0.5, weight_decay=weight_decay)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    tx = j_make_optimizer(jcfg(cfg), steps_per_epoch=2)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tparams = [torch.tensor(params[k]) for k in shapes]
    adam = tt.Adam(tt.make_lr_schedule(cfg, 2), weight_decay)
    state = tt.Adam.init(tparams)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.tensor(g[k]) for k in shapes]
        norm = tt.global_norm(tg)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        assert (float(norm) < cfg.clip_grad_norm) == (grad_scale < 1)
        adam.update(tparams, tt.clip_by_global_norm(tg, norm, cfg.clip_grad_norm), state)
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)
    assert state["count"] == 2


@pytest.fixture(scope="module")
def dbs():
    return j_db(), t_db()


@pytest.mark.parametrize("case", ["plain", "domain_rand+occlude", "textured"])
def test_synthetic_batch_matches_jax(dbs, case):
    jdb, tdb_ = quad_dbs(plain=True) if case == "textured" else dbs
    B = 3
    key = jax.random.PRNGKey(3 if case == "textured" else 21)  # 3: two of the three draw the quad
    extras = case == "domain_rand+occlude"
    kw = dict(domain_rand=extras, occlude=extras)
    jb = jax.jit(j_synthetic_batch_fn(jdb, B, INPUT, f=120.0, renderer="tiled", **kw))(key)
    synth = tt.synthetic_batch_fn(tdb_, B, INPUT, f=120.0, device="cpu", **kw)
    draws = jax_synthetic_draws(key, B, len(tdb_.labels), **kw)
    port_draws = synth.draw(torch.Generator().manual_seed(0))
    assert {k: (v.shape, v.dtype) for k, v in draws.items()} == {
        k: (v.shape, v.dtype) for k, v in port_draws.items()}
    tb = synth.make(draws)
    for name in ("TCO", "K", "bboxes"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), atol=1e-4)
    np.testing.assert_array_equal(tb.mesh_idx.numpy(), np.asarray(jb.mesh_idx))
    diff = np.abs(tb.rgbs.numpy() - np.asarray(jb.rgbs)).max(-1)
    off = diff > 1e-4
    assert off.sum() <= 8, (off.sum(), diff.max())
    assert np.asarray(jb.rgbs).max() > 0.1
    if extras:
        assert (tb.rgbs == 0).all(-1).float().mean() < 0.01  # a background everywhere
    if case == "textured":
        assert tb.rgbs[tdb_.has_tex[tb.mesh_idx]].max() > 0.1  # a textured quad in sight


def tiny_cfg(tmp_path, **kw) -> TrainingConfig:
    cfg = run_training.make_config("refiner", False, [a for a in TINY if a.split("=")[0] in
                                                      TrainingConfig.__dataclass_fields__])
    return dataclasses.replace(cfg, run_dir=str(tmp_path), **kw)


def test_checkpoint_round_trip(tmp_path, dbs):
    cfg = tiny_cfg(tmp_path)
    synth = tt.synthetic_batch_fn(dbs[1], 2, cfg.input_resize, device="cpu")
    state = tt.create_train_state(cfg, device="cpu")
    draws = tt.draw_forward_loss(cfg, 2, dbs[1].points.shape[1], torch.Generator().manual_seed(1))
    tt.train_step(state, cfg, synth(torch.Generator().manual_seed(0)), dbs[1], draws, 1)
    tt.save_checkpoint(tmp_path / "a", state, 3)
    assert (tmp_path / "a/checkpoints/latest.txt").read_text() == "3"
    fresh, epoch = tt.load_checkpoint(tmp_path / "a", tt.create_train_state(
        dataclasses.replace(cfg, seed=5), device="cpu"))
    assert epoch == 3 and fresh.step == state.step == 1 and fresh.opt_state["count"] == 1
    for a, b in zip(state.params + state.opt_state["mu"] + state.opt_state["nu"],
                    fresh.params + fresh.opt_state["mu"] + fresh.opt_state["nu"]):
        assert torch.equal(a, b)
    pre = tt.load_pretrained(tmp_path / "a", tt.create_train_state(dataclasses.replace(cfg, seed=5), "cpu"))
    assert pre.step == 0 and all(torch.equal(a, b) for a, b in zip(state.params, pre.params))
    assert all((m == 0).all() for m in pre.opt_state["mu"])
    # Pretraining from an npz export of JAX params (`/`-joined keys).
    _, params = init_jax_model(cfg, dbs[0], seed=3)
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "jax.npz", **flat)
    pre = tt.load_pretrained(tmp_path / "jax.npz", tt.create_train_state(cfg, "cpu"))
    want = state_dict_from_jax(jax.tree.map(np.asarray, params))
    assert all(torch.equal(want[n], p) for n, p in pre.model.named_parameters())
    shutil.rmtree(tmp_path)


def test_resume_equals_unbroken_run(tmp_path):
    """2 + 2 epochs of one step each, resumed through the CLI, against 4."""
    args = TINY + [f"run_dir={tmp_path}", "save_epoch_interval=100", "val_epoch_interval=100"]
    whole = run_training.main(args + ["n_epochs=4", "run_id=whole"])
    run_training.main(args + ["n_epochs=2", "run_id=part"])
    resumed = run_training.main(args + ["n_epochs=4", "resume_run_id=part"])
    assert resumed.step == whole.step == 4
    for a, b in zip(whole.params, resumed.params):
        assert torch.equal(a, b)
    logs = [json.loads(l) for l in (tmp_path / "part/log.txt").read_text().splitlines()]
    assert [l["epoch"] for l in logs] == [1, 2, 3, 4]
    assert sorted(p.name for p in (tmp_path / "part/checkpoints").iterdir()) == [
        "epoch_2", "epoch_4", "latest.txt"]
    shutil.rmtree(tmp_path)


def test_run_training_cli(tmp_path):
    state = run_training.main(TINY + [f"run_dir={tmp_path}", "n_epochs=1", "val_epoch_interval=1"])
    run = tmp_path / "refiner-run"
    (log,) = [json.loads(l) for l in (run / "log.txt").read_text().splitlines()]
    assert set(log) == JAX_LOG_KEYS and all(np.isfinite(v) for v in log.values())
    assert (run / "checkpoints/epoch_1/state.pt").exists() and state.step == 1
    assert load_config(run / "config.json").backbone_str == "resnet18"
    with pytest.raises(NotImplementedError, match="M10"):
        run_training.main([a for a in TINY if a != "synthetic=1"] + [f"run_dir={tmp_path}"])
    shutil.rmtree(tmp_path)
