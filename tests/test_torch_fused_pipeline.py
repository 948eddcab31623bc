"""Port vs JAX: hierarchical SO(3) pruning, the fused mode (padded to
`max_detections`) and `keep_all_coarse_outputs`, at the small setup of
`tests/torch_production_refs.py` (its docstring states the tolerances).
On the CPU the fused mode runs its function eagerly; the CUDA graph is
held to that function bit for bit in `tests/test_torch_fused_cuda.py`.
"""

import numpy as np
import pytest
import torch

from tests.torch_production_refs import assert_outputs_match, assert_poses_close, make_scene
from tests.torch_production_refs import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_pruned_keep_all_matches_full_sweep(scene):
    """Keeping every probe rotation, the children are the whole grid (the
    Voronoi cells partition it), so the pruned stage picks the full
    sweep's poses (as tests/test_pose_estimator.py does for JAX)."""
    obs, dets = scene.port_request(["cube"])
    full, _ = scene.port_estimator().run_inference_pipeline(obs, dets)
    pruned, extra = scene.port_estimator(SO3_prune_grid_size=4, SO3_prune_keep=4).run_inference_pipeline(obs, dets)
    np.testing.assert_allclose(full.poses.numpy(), pruned.poses.numpy(), atol=1e-5)
    assert torch.isinf(extra["coarse"]["logits"]).sum() > 0  # padded child slots


def test_fused_pruned_padded_matches_jax(scene):
    """4 -> 2 pruning, fused, two detections padded to four: the port's
    outputs (sliced to the two) against the JAX package's, every
    hypothesis a member of the 16 grid; the port's fused run against its
    phased run within 1e-4; `keep_all_coarse_outputs`."""
    kw = dict(SO3_prune_grid_size=4, SO3_prune_keep=2, fused_pipeline=True)
    jout, jx = scene.jax_estimator(**kw).run_inference_pipeline(*scene.jax_request(), keep_all_coarse_outputs=True)
    est = scene.port_estimator(**kw)
    tout, tx = est.run_inference_pipeline(*scene.port_request(), keep_all_coarse_outputs=True)
    assert set(tx["timing"]) == {"total"} and tout.labels == ["cube", "sphere"]
    assert tuple(tx["coarse"]["logits"].shape) == (2, 2 * est.prune_children.shape[1])
    assert tuple(tx["refiner"]["trajectory"].shape) == (2, 2, 3, 4, 4)
    assert_outputs_match(jout, jx, tout, tx)
    assert torch.equal(tx["coarse"]["all_TCO"], tx["coarse"]["TCO_init"])
    np.testing.assert_allclose(jx["coarse"]["all_TCO"], tx["coarse"]["all_TCO"].numpy(), atol=1e-5)
    R = tx["coarse"]["TCO_init"][..., :3, :3].reshape(-1, 1, 9)
    assert (R - est.so3_grid.reshape(1, -1, 9)).abs().amax(-1).amin(-1).max() < 1e-5

    phased, px = scene.port_estimator(**{**kw, "fused_pipeline": False}).run_inference_pipeline(*scene.port_request())
    np.testing.assert_allclose(tout.poses.numpy(), phased.poses.numpy(), atol=1e-4)
    np.testing.assert_allclose(tx["coarse"]["logits"].numpy(), px["coarse"]["logits"].numpy(), atol=2e-4)
    assert set(px["timing"]) == {"coarse", "refiner", "scoring", "total"}


def test_fused_matches_jax_fused_and_port_phased(scene):
    """The unpruned fused mode with one detection padded to four."""
    jout, jx = scene.jax_estimator(fused_pipeline=True).run_inference_pipeline(*scene.jax_request(["cube"]))
    tout, tx = scene.port_estimator(fused_pipeline=True).run_inference_pipeline(*scene.port_request(["cube"]))
    assert_outputs_match(jout, jx, tout, tx)
    phased, _ = scene.port_estimator().run_inference_pipeline(*scene.port_request(["cube"]))
    np.testing.assert_allclose(tout.poses.numpy(), phased.poses.numpy(), atol=1e-4)
    assert_poses_close(jout.poses, phased.poses)
