"""Port vs JAX: a tiny `demo_finalize_pipeline` (as
tests/test_demo_scripts.py runs the JAX script: SO(3) grid 8, one
evaluation scene, 48x64, one refiner iteration) from the same weights:
freshly initialised params, handed to the JAX script in place of its
orbax checkpoints and to the port as npz exports. The port's core is fed
the JAX script's evaluation batch (rendered by its scan renderer) and its
noise normals.

Each A/B builds estimators whose programs the JAX package compiles anew,
~12 s each on a CPU, so the JAX script runs the small native scorer and
the combined A/B (pruning 4 -> 2 with the small scorer and top-2), and the
port all five: its `lod_ab`, `coarse_res_ab` and `prune_ab` are checked
complete and finite here, and their modules are held against the JAX
package in tests/test_torch_production_options.py.

Tolerances: the report's keys and integer and list values equal; the
initial errors within 1e-3 (mm and degrees: the same poses in f32); the
refined, pipeline and A/B errors within 0.1 mm and 0.1 degree (the
refiner's tolerance of `tests/test_torch_pose_estimator.py`), the worst
frame deltas within 0.2 mm (a difference of two errors); the fractions
equal.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.models import PosePredictor as JPosePredictor
from megapose6d_tpu.models import PosePredictorConfig as JPosePredictorConfig
from megapose6d_tpu.models.pose_predictor import skip_render_for_init
from megapose6d_tpu.scripts import demo_finalize_pipeline as jdfp
from megapose6d_tpu.scripts.demo_synthetic_e2e import build_world as jbuild_world
from megapose6d_tpu.training import config as jtc
from megapose6d_tpu.training.train import synthetic_batch_fn
from megapose6d_tpu_torch.scripts import demo_finalize_pipeline as dfp
from megapose6d_tpu_torch.meshes.worlds import build_world
from megapose6d_tpu_torch.training.forward_loss import BatchPoseData
from tests.test_torch_checkpoints import flatten
from tests.torch_production_refs import one_torch_thread  # noqa: F401 (autouse)

RENDER = (48, 64)
ARGS = ["so3=8", "n_eval=1", "refine_iters=1", "render=48,64", "batch_size=2", "backbone=resnet18-spatial",
        "dtype=float32", "coarse_render=24,32", "prune_grid=4", "prune_keep=2", "combo_ab=1", "combo_top_k=2"]
PORT_ONLY = ("lod_ab", "coarse_res_ab", "prune_ab")


def init_params(cfg, model, mesh_db, key, res):
    """`model.init` at `PRNGKey(key)` with the render bypassed, as the JAX
    package initialises off the CPU: the params depend on the shapes and
    the key only, and the init takes seconds instead of half a minute."""
    with skip_render_for_init():
        return jax.jit(model.init)(
            jax.random.PRNGKey(key), jnp.zeros((1,) + res + (3 + cfg.input_depth,)), jnp.eye(3)[None] * 100.0,
            jnp.eye(4)[None].at[0, 2, 3].set(0.5), mesh_db.select(jnp.zeros((1,), jnp.int32)))


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("final")
    jmesh = jbuild_world()
    base = jtc.TrainingConfig(input_resize=RENDER, render_size=RENDER, batch_size=2,
                              backbone_str="resnet18-spatial", compute_dtype="float32", n_points_loss=256,
                              epoch_size=2)
    ref_cfg = dataclasses.replace(jtc.make_refiner_cfg(base), n_rendered_views=2, multiview_type="front_1view",
                                  n_iterations=1)
    coarse_cfg = dataclasses.replace(jtc.make_coarse_cfg(base), n_hypotheses=4)
    small_cfg = dataclasses.replace(coarse_cfg, input_resize=(24, 32), render_size=(24, 32))
    params, npz = {}, {}
    for name, cfg, key, res in (("ref", ref_cfg, 0, RENDER), ("coarse", coarse_cfg, 1, RENDER),
                                ("small", small_cfg, 2, (24, 32))):
        model = JPosePredictor(JPosePredictorConfig(**cfg.model_config_kwargs()))
        params[key] = init_params(cfg, model, jmesh, key, res)
        npz[name] = tmp / f"{name}@2.npz"
        np.savez(npz[name], **flatten(jax.tree.map(np.asarray, params[key])))
    (tmp / "small").mkdir()
    jtc.save_config(small_cfg, tmp / "small" / "config.json")

    def create_train_state(cfg, model, mesh_db, key, input_res=None):
        """The JAX script's states at PRNGKey 0 (refiner), 1 (coarse) and 2
        (small scorer) hold the params made above for that key."""
        return types.SimpleNamespace(params=params[int(np.asarray(key)[-1])])

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEGAPOSE_TPU_COMPILE_CACHE", str(tmp / "xla"))
        mp.setattr(jdfp, "create_train_state", create_train_state)
        mp.setattr(jdfp, "load_checkpoint", lambda run_dir, state, epoch=None, params_only=False: (state, 2))
        want = jdfp.main(ARGS + [f"refiner_dir={tmp / 'ref'}", f"coarse_dir={tmp / 'coarse'}",
                                 f"coarse2_dir={tmp / 'small'}", f"out_dir={tmp / 'jax'}"])
    # The JAX script's evaluation batch and noise.
    b = jax.jit(synthetic_batch_fn(jmesh, 16, RENDER, f=400.0))(jax.random.PRNGKey(9999))
    kr, kt = jax.random.split(jax.random.PRNGKey(7))
    noise = tuple(torch.as_tensor(np.asarray(jax.random.normal(k, (16, 3)))) for k in (kr, kt))

    args = dfp.parse_args(ARGS + ["lod_ab=1", "coarse_res_ab=1", "prune_ab=1", f"refiner_dir={npz['ref']}",
                                  f"coarse_dir={npz['coarse']}", f"coarse2_dir={tmp / 'small'}", f"coarse2_weights={npz['small']}",
                                  "device=cpu", f"out_dir={tmp / 'port'}"])
    mesh_db = build_world(device="cpu")
    models = dfp.build_models(args, mesh_db, RENDER, "float32")
    batch = BatchPoseData(**{k: torch.as_tensor(np.asarray(getattr(b, k)))
                             for k in ("rgbs", "K", "TCO", "bboxes", "mesh_idx")})
    batch.mesh_idx = batch.mesh_idx.long()
    got = dfp.evaluate(args, mesh_db, models, batch, noise)
    return json.loads(json.dumps(want)), json.loads(json.dumps(got))


def walk(a, b, key=""):
    """(key, JAX value, port value) of every leaf, after checking that the
    two reports have the same keys."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (key, list(a), list(b))
        for k in a:
            yield from walk(a[k], b[k], f"{key}.{k}" if key else k)
    else:
        yield key, a, b


def tolerance(key: str) -> float:
    if key.startswith("init."):
        return 1e-3
    if key.endswith("worst_frame_delta"):
        return 0.2
    return 0.1


def test_tiny_report_matches_jax(reports):
    want, got = reports
    assert all(want[k] is not None for k in ("coarse_small_ab", "combo_ab"))
    for k in PORT_ONLY:
        assert want[k] is None and got[k]["add_mm_full"] == got["pipeline"]["add_mm"]
        assert all(np.isfinite(v) for v in got[k].values() if isinstance(v, float)), got[k]
    n = 0
    for key, a, b in walk(want, {**got, **dict.fromkeys(PORT_ONLY)}):
        if key in ("coarse_dir", "coarse_small_ab.coarse2_dir"):  # a run directory, or an npz, by package
            assert isinstance(a, str) and isinstance(b, str)
        elif isinstance(a, (bool, int, list)) or a is None or key.endswith("_frac"):
            assert a == b, (key, a, b)
        else:
            assert abs(a - b) <= tolerance(key), (key, a, b)
        n += 1
    assert n == 40  # every leaf of the two reports
