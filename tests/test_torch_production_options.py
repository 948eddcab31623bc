"""Port vs JAX: the coarse sweep at `coarse_render_size` on a LOD mesh
database (`mesh_db_coarse`), the float32 rescore of a bfloat16 coarse
model (`rescore_f32`) and external initial poses
(`coarse_estimation_type="external"`), at the small setup of
`tests/torch_production_refs.py` (its docstring states the tolerances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.data.tensor_collection import PandasTensorCollection
from megapose6d_tpu_torch.data.tensor_collection import TensorCollection
from tests.torch_production_refs import (
    assert_logits_close,
    assert_outputs_match,
    assert_poses_close,
    make_scene,
    one_torch_thread,  # noqa: F401 (autouse)
)


@pytest.fixture(scope="module")
def scene():
    return make_scene(bf16_coarse=True)


def test_coarse_render_size_on_lod_matches_jax(scene):
    """The sweep's renders rasterised at 24x32 from the 64-face database and
    upsampled to 48x64; the refiner renders the full database; the twin
    shares the coarse model's parameters."""
    kw = dict(coarse_render_size=(24, 32))
    jest = scene.jax_estimator(lod=True, **kw)
    jout, jx = jest.run_inference_pipeline(*scene.jax_request())
    est = scene.port_estimator(lod=True, **kw)
    tout, tx = est.run_inference_pipeline(*scene.port_request())
    assert est.coarse_model_sweep.cfg.render_at == (24, 32) and est.coarse_model_rescore is est.coarse_model
    assert all(a is b for a, b in zip(est.coarse_model_sweep.parameters(), est.coarse_model.parameters()))
    assert est.mesh_db_coarse is scene.tlod and scene.tlod.faces.shape[1] == 64
    assert_outputs_match(jout, jx, tout, tx)


def test_rescore_f32_of_bf16_coarse_model(scene):
    """The rescore twin of a bfloat16 coarse model computes exactly what a
    float32 model with the same weights computes, and what the JAX
    package's twin computes; the pipeline runs with it."""
    est16 = scene.port_estimator(coarse="coarse_bf16", rescore_f32=True)
    est32 = scene.port_estimator()
    assert est16.coarse_model_rescore is not est16.coarse_model
    assert est16.coarse_model_rescore.cfg.compute_dtype == "float32"
    assert est16.coarse_model.cfg.compute_dtype == "bfloat16"
    TCO = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    TCO[:, 2, 3] = 0.5
    TCO[1, 0, 3] = 0.01
    obs, _ = scene.port_request()
    idx = torch.zeros(2, dtype=torch.long)
    with torch.inference_mode():
        twin = est16.rescore(2, obs.images, obs.K, torch.as_tensor(TCO), idx)
        f32 = est32.rescore(2, obs.images, obs.K, torch.as_tensor(TCO), idx)
    assert torch.equal(twin, f32)
    jest16 = scene.jax_estimator(coarse="coarse_bf16", rescore_f32=True)
    jlogits = jest16._rescore(2, jest16.coarse_params, jnp.asarray(scene.obs), jnp.asarray(obs.K.numpy()),
                              jnp.asarray(TCO), jnp.zeros((2,), jnp.int32))
    assert_logits_close(np.asarray(jlogits), twin)
    out, _ = est16.run_inference_pipeline(*scene.port_request())
    assert torch.isfinite(out.poses).all()


def test_external_initial_poses_match_jax(scene):
    """Given `TCO_init`, the refiner and the rescore, the coarse stage
    skipped (as tests/test_zoo_and_external.py does for JAX)."""
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T[:, 2, 3] = [0.5, 0.52]
    T[1, :3, 3] += [0.01, -0.005, 0.0]
    jobs, jdets = scene.jax_request()
    jdets = PandasTensorCollection(jdets.infos, bboxes=np.asarray(jdets.bboxes), TCO_init=T)
    jout, jx = scene.jax_estimator(coarse_estimation_type="external").run_inference_pipeline(jobs, jdets)
    tobs, tdets = scene.port_request()
    tdets = TensorCollection(infos=tdets.infos, bboxes=tdets.bboxes, TCO_init=torch.as_tensor(T))
    est = scene.port_estimator(coarse_estimation_type="external")
    tout, tx = est.run_inference_pipeline(tobs, tdets)
    assert tuple(tx["refiner"]["trajectory"].shape) == (2, 2, 4, 4)
    assert set(tx["timing"]) == {"refiner", "scoring", "total"} and "coarse" not in tx
    assert_poses_close(jx["refiner"]["trajectory"], tx["refiner"]["trajectory"])
    assert_poses_close(jout.poses, tout.poses)
    assert_logits_close(jout.infos["pose_logit"].to_numpy(), tout.pose_logit)
    np.testing.assert_allclose(jout.infos["pose_score"].to_numpy(), tout.infos["pose_score"], atol=0.05)
    with pytest.raises(ValueError):
        est.run_inference_pipeline(*scene.port_request())  # no TCO_init
