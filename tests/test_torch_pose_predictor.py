"""Port vs JAX: PosePredictor steps and the committed checkpoints.

Random flax params are carried across with `interop.from_jax` and
`score_views` / `refine_step` are held against the JAX module at a small
size (48x64 renders, resnet18-spatial, f32, TF32 off). The committed `runs/coarse_dr` and
`runs/refiner_dr` weights are read with the JAX package's own loader,
converted, and `net_forward` is held at f32 and at bf16 (the runs'
`compute_dtype`) at the full 240x320 width.
Tolerances: logits and 9D outputs atol 1e-4 (f32 CNN sums taken in another
order); poses atol 1e-5; crops and renders atol 1e-4. The trained
checkpoints' outputs reach ~6, so there atol 1e-4 is joined by rtol 1e-4.
At bf16 each package rounds activations to 8 mantissa bits at its own
places: measured on two random inputs, the largest difference was 0.9% of
the largest output for coarse_dr's logits and 1.4% for refiner_dr's 9D
outputs, so bf16 is held to 3% of the largest output.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from megapose6d_tpu.meshes import MeshDataBase, RigidObject, RigidObjectDataset, make_cube, make_uv_sphere
from megapose6d_tpu.models import pose_predictor as jpp
from megapose6d_tpu.training.config import load_config
from megapose6d_tpu.training.train import TrainState, load_checkpoint
from megapose6d_tpu_torch.interop.from_jax import config_from_run_json, state_dict_from_jax
from megapose6d_tpu_torch.meshes import mesh_db as tdb
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.models import pose_predictor as tpp
from megapose6d_tpu_torch.ops._precision import pin_f32

pin_f32()
RUNS = Path(__file__).resolve().parents[1] / "runs"
RENDER = (48, 64)
IMG = (60, 80)


def j_db():
    objs = RigidObjectDataset([
        RigidObject(label="cube", mesh=make_cube(0.04)),
        RigidObject(label="sphere", mesh=make_uv_sphere(0.035, 8, 12)),
    ])
    return MeshDataBase.from_object_ds(objs, max_faces=256, n_points=128, n_sym=4).batched(align=32)


def t_db():
    objs = tdb.RigidObjectDataset([
        tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04)),
        tdb.RigidObject(label="sphere", mesh=tio.make_uv_sphere(0.035, 8, 12)),
    ])
    return tdb.MeshDataBase.from_object_ds(objs, max_faces=256, n_points=128, n_sym=4).batched(
        align=32, device="cpu")


def scene(rng, B):
    img = rng.uniform(size=(B,) + IMG + (3,)).astype(np.float32)
    K = np.tile(np.asarray([[95.0, 0, 39.5], [0, 95.0, 29.5], [0, 0, 1]], np.float32), (B, 1, 1))
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    ang = rng.uniform(-0.6, 0.6, size=B)
    TCO[:, 0, 0], TCO[:, 0, 2], TCO[:, 2, 0], TCO[:, 2, 2] = np.cos(ang), np.sin(ang), -np.sin(ang), np.cos(ang)
    TCO[:, :3, 3] = np.stack([rng.normal(scale=0.01, size=B), rng.normal(scale=0.01, size=B),
                              rng.uniform(0.35, 0.5, size=B)], -1)
    return img, K, TCO


def init_both(cfg_kw, make_j, make_t, seed):
    cfg_kw = dict(cfg_kw, backbone="resnet18-spatial")
    jmodel = jpp.PosePredictor(make_j(render_size=RENDER, **cfg_kw))
    db = j_db()
    with jpp.skip_render_for_init():
        params = jax.jit(jmodel.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1,) + IMG + (3,)), jnp.eye(3)[None] * 100.0,
            jnp.eye(4)[None].at[0, 2, 3].set(0.5), db.select(jnp.zeros((1,), jnp.int32)))
    tmodel = tpp.PosePredictor(make_t(render_size=RENDER, **cfg_kw))
    tmodel.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel.eval(), db, t_db()


def japply(model, params, method, *args):
    """The JAX module's method, jitted (eager flax runs op by op)."""
    return jax.jit(lambda p, *a: model.apply(p, *a, method=method))(params, *args)


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol, rtol=rtol)


def test_score_views_matches_jax(rng):
    jm, params, tm, jdb, tdb_ = init_both({}, jpp.make_coarse_config, tpp.make_coarse_config, 0)
    img, K, TCO = scene(rng, 3)
    labels = ["cube", "sphere", "cube"]
    jout = japply(jm, params, jpp.PosePredictor.score_views, jnp.asarray(img), jnp.asarray(K),
                  jnp.asarray(TCO), jdb.select(jdb.label_to_index(labels)))
    with torch.no_grad():
        tout = tm.score_views(torch.as_tensor(img), torch.as_tensor(K), torch.as_tensor(TCO),
                              tdb_.select(tdb_.label_to_index(labels)))
    close(jout["boxes_crop"], tout["boxes_crop"], 1e-3)  # pixels
    close(jout["images_crop"], tout["images_crop"], 1e-4)
    close(jout["renders"], tout["renders"], 1e-4)
    close(jout["logits"], tout["logits"], 1e-4)


def test_refine_step_matches_jax(rng):
    kw = dict(n_rendered_views=2, multiview_type="TCO+front_1view")
    jm, params, tm, jdb, tdb_ = init_both(kw, jpp.make_refiner_config, tpp.make_refiner_config, 1)
    img, K, TCO = scene(rng, 2)
    labels = ["sphere", "cube"]
    jout = japply(jm, params, jpp.PosePredictor.refine_step, jnp.asarray(img), jnp.asarray(K),
                  jnp.asarray(TCO), jdb.select(jdb.label_to_index(labels)))
    with torch.no_grad():
        tout = tm.refine_step(torch.as_tensor(img), torch.as_tensor(K), torch.as_tensor(TCO),
                              tdb_.select(tdb_.label_to_index(labels)))
    close(jout["renders"], tout["renders"], 1e-4)
    assert tout["renders"].shape[-1] == 12 and (tout["renders"][..., 6:9] > 0).any()
    close(jout["network_outputs"]["pose"], tout["network_outputs"]["pose"], 1e-4)
    close(jout["TCO_output"], tout["TCO_output"], 1e-5)


@pytest.mark.parametrize("run,dtype", [
    pytest.param("coarse_dr", "float32", id="coarse_dr"),
    pytest.param("refiner_dr", "float32", id="refiner_dr"),
    pytest.param("coarse_dr", "bfloat16", id="coarse_dr-bf16"),
    pytest.param("refiner_dr", "bfloat16", id="refiner_dr-bf16"),
])
def test_committed_checkpoint_net_forward_f32(rng, run, dtype):
    """The committed weights give the JAX model's outputs at f32, and at
    bf16 as the runs compute."""
    run_dir = RUNS / run
    jcfg = load_config(run_dir / "config.json")
    jmodel = jpp.PosePredictor(jpp.PosePredictorConfig(
        **{**jcfg.model_config_kwargs(), "compute_dtype": dtype}))
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
    params = jax.tree.map(np.asarray, state.params)

    tcfg, db_kw = config_from_run_json(run_dir / "config.json")
    assert tcfg.backbone == "resnet18-spatial" and tcfg.compute_dtype == "bfloat16"
    assert db_kw == {"max_faces": 4096, "n_points_mesh": 2000, "n_sym": 32}
    if run == "refiner_dr":
        assert tcfg.multiview_type == "TCO+front_1view" and tcfg.n_rendered_views == 2
    tmodel = tpp.PosePredictor(tpp.PosePredictorConfig(
        **{**tcfg.__dict__, "compute_dtype": dtype})).eval()
    tmodel.load_state_dict(state_dict_from_jax(params))

    x = rng.uniform(size=(2,) + tuple(tcfg.render_size) + (tcfg.n_inputs,)).astype(np.float32)
    jout = japply(jmodel, params, jpp.PosePredictor.net_forward, jnp.asarray(x))
    with torch.no_grad():
        tout = tmodel.net_forward(torch.as_tensor(x))
    assert set(jout) == set(tout)
    for k in jout:
        if dtype == "float32":
            close(jout[k], tout[k], 1e-4, rtol=1e-4)
        else:
            a, b = np.asarray(jout[k], np.float32), tout[k].float().numpy()
            assert np.abs(a - b).max() <= 0.03 * np.abs(a).max(), (k, np.abs(a - b).max())
