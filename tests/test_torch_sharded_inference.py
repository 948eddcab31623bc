"""Port vs JAX: sharded inference.

On the mesh `[cpu, cpu]`, at the setup of `tests/test_sharded_inference.py`
(one cube, SO(3) grid 16, one refiner iteration, 2 hypotheses, chunks of
2; plain and pruned 4 -> children; `tests/test_torch_sharded_padding.py`
runs the padded case through this module's helpers), with the JAX params
carried across:
against the port unsharded, coarse logits atol 2e-4 and final poses atol
1e-4 (that test's tolerances; the padded slots of the pruned sweep -inf
in both); against the JAX package's sharded run on a 2-device mesh, the
tolerances of `tests/test_torch_pose_estimator.py` (coarse logits within
0.05, at least 90% within 1e-4; poses within 0.1 degree and 0.1 mm, at
least half within 0.001 degree and 0.001 mm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.data import ObservationTensor as JObservation
from megapose6d_tpu.inference import InferenceConfig as JInferenceConfig
from megapose6d_tpu.inference import PoseEstimator as JPoseEstimator
from megapose6d_tpu.inference import make_detections as jmake_detections
from megapose6d_tpu.meshes import MeshDataBase as JMeshDataBase
from megapose6d_tpu.meshes import RigidObject as JRigidObject
from megapose6d_tpu.meshes import RigidObjectDataset as JRigidObjectDataset
from megapose6d_tpu.meshes.io import make_cube
from megapose6d_tpu.models import PosePredictor as JPosePredictor
from megapose6d_tpu.models import make_coarse_config as j_coarse_config
from megapose6d_tpu.models import make_refiner_config as j_refiner_config
from megapose6d_tpu.ops import rasterizer
from megapose6d_tpu.parallel import make_mesh as j_make_mesh
from megapose6d_tpu_torch.data.types import ObservationTensor
from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
from megapose6d_tpu_torch.inference.types import InferenceConfig, make_detections
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.meshes import mesh_db as tdb
from megapose6d_tpu_torch.models import pose_predictor as tpp
from megapose6d_tpu_torch.ops._precision import pin_f32
from tests.test_torch_pose_estimator import assert_logits_close, assert_poses_close

pin_f32()
IMG = (72, 96)
K = np.asarray([[120.0, 0, 48], [0, 120.0, 36], [0, 0, 1]], np.float32)
BASE = dict(SO3_grid_size=16, n_refiner_iterations=1, n_pose_hypotheses=2, bsz_images=2, bsz_objects=2,
            max_detections=1)
CASES = {"plain": {}, "pruned": dict(SO3_prune_grid_size=4, SO3_prune_keep=2)}


def sharded_rows(n: int, chunk: int, n_dev: int = 2) -> int:
    """Rows of `n` hypotheses in the sharded mode, pads included:
    `ceil(n / (n_dev * c)) * c` per device, `c = min(chunk, ceil(n / n_dev))`."""
    c = min(chunk, -(-n // n_dev))
    return n_dev * -(-n // (n_dev * c)) * c


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module, restored after it: the test
    workers' thread pools otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cases(cases: dict) -> dict:
    """Per case of `cases` (`InferenceConfig` settings over `BASE`): the
    JAX package's run on a 2-device mesh, and the port's unsharded and on
    [cpu, cpu], from the same params and observation."""
    jdb = JMeshDataBase.from_object_ds(JRigidObjectDataset([JRigidObject(label="cube", mesh=make_cube(0.04))]),
                                       max_faces=64, n_points=64, n_sym=2).batched(align=32)
    tdb_ = tdb.MeshDataBase.from_object_ds(
        tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04))]),
        max_faces=64, n_points=64, n_sym=2).batched(align=32, device="cpu")
    jc = JPosePredictor(j_coarse_config(render_size=(48, 64), face_chunk=32))
    jr = JPosePredictor(j_refiner_config(render_size=(48, 64), n_rendered_views=1, multiview_type="TCO+front_1view",
                                         face_chunk=32))
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 0.5
    m1 = jdb.select(jnp.zeros((1,), jnp.int32))
    obs = np.asarray(rasterizer.render_meshes(m1.vertices, m1.normals, m1.colors, m1.faces, m1.face_valid,
                                              jnp.asarray(T)[None], jnp.asarray(K)[None], IMG,
                                              light_ambient=1.0, light_point=0.0).rgb)
    cparams = jc.init(jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(K)[None], jnp.asarray(T)[None], m1)
    rparams = jr.init(jax.random.PRNGKey(1), jnp.asarray(obs), jnp.asarray(K)[None], jnp.asarray(T)[None], m1)
    tc = tpp.PosePredictor(tpp.make_coarse_config(render_size=(48, 64)))
    tr = tpp.PosePredictor(tpp.make_refiner_config(render_size=(48, 64), n_rendered_views=1,
                                                   multiview_type="TCO+front_1view"))
    tc.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, cparams)))
    tr.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, rparams)))
    box = np.asarray([[30.0, 20, 70, 55]])
    tobs = ObservationTensor(torch.as_tensor(obs), torch.as_tensor(K[None]))
    out = {}
    for case, kw in cases.items():
        cfg = dict(BASE, **kw)
        jest = JPoseEstimator(jc, cparams, jr, rparams, jdb, JInferenceConfig(**cfg), device_mesh=j_make_mesh(2))
        j = jest.run_inference_pipeline(JObservation(images=obs, K=K[None]), jmake_detections(["cube"], box))
        runs = {}
        for name, mesh in (("single", None), ("sharded", ["cpu", "cpu"])):
            est = PoseEstimator(tc, tr, tdb_, InferenceConfig(**cfg), device="cpu", device_mesh=mesh)
            runs[name] = est.run_inference_pipeline(tobs, make_detections(["cube"], box, device="cpu"))
        out[case] = (j, runs)
    return out


@pytest.fixture(scope="module")
def inference():
    return run_cases(CASES)


def check_against_unsharded(inference: dict, case: str, kw: dict, pruned: bool, padded: bool) -> None:
    """The sharded run of `case` against the unsharded one; whether its
    coarse logits hold pruned slots (-inf) and whether both of its sweeps
    padded (coarse, refiner) are as said."""
    _, runs = inference[case]
    (out_s, ex_s), (out_1, ex_1) = runs["sharded"], runs["single"]
    ls, l1 = ex_s["coarse"]["logits"].numpy(), ex_1["coarse"]["logits"].numpy()
    assert ls.shape == l1.shape
    np.testing.assert_array_equal(np.isinf(ls), np.isinf(l1))
    assert np.isinf(ls).any() == pruned
    f = np.isfinite(l1)
    np.testing.assert_allclose(ls[f], l1[f], atol=2e-4)
    np.testing.assert_allclose(out_s.poses.numpy(), out_1.poses.numpy(), atol=1e-4)
    assert tuple(ex_s["refiner"]["trajectory"].shape) == tuple(ex_1["refiner"]["trajectory"].shape)
    assert np.isfinite(out_s.poses.numpy()).all() and np.isfinite(ex_s["refiner"]["trajectory"].numpy()).all()
    cfg = InferenceConfig(**dict(BASE, **kw))
    n_coarse, n_refine = ls.size, cfg.n_pose_hypotheses
    pads = (sharded_rows(n_coarse, cfg.bsz_images) > n_coarse, sharded_rows(n_refine, cfg.bsz_objects) > n_refine)
    assert pads == (padded, padded)


def check_against_jax(inference: dict, case: str) -> None:
    """The port's sharded run of `case` against the JAX package's."""
    (jout, jx), runs = inference[case]
    tout, tx = runs["sharded"]
    jl, tl = np.asarray(jx["coarse"]["logits"]), tx["coarse"]["logits"].numpy()
    np.testing.assert_array_equal(np.isinf(jl), np.isinf(tl))
    f = np.isfinite(jl)
    assert_logits_close(jl[f], torch.as_tensor(tl[f]), min_tight=0.9)
    assert_poses_close(jx["refiner"]["TCO_refined"], tx["refiner"]["TCO_refined"])
    assert_poses_close(jout.poses, tout.poses)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_inference_matches_unsharded(inference, case):
    check_against_unsharded(inference, case, CASES[case], pruned=case == "pruned", padded=False)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_inference_matches_jax_sharded(inference, case):
    check_against_jax(inference, case)
