"""The fused pipeline as a CUDA graph, and the visibility kernel at the
production configuration's launch shapes, on the card.

Skipped without a CUDA device. On the card (no JAX there, so without the
repository's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_fused_cuda.py

A graph replays the kernels its capture recorded on the same buffers, so
its outputs must equal an eager run of the same function bit for bit; the
kernel must equal its plain twin bit for bit at every shape.
"""

import numpy as np
import pytest
import torch

from megapose6d_tpu_torch.data.types import ObservationTensor
from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
from megapose6d_tpu_torch.inference.types import InferenceConfig, make_detections
from megapose6d_tpu_torch.meshes import io as mesh_io
from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase, RigidObject, RigidObjectDataset
from megapose6d_tpu_torch.models import pose_predictor as tpp
from megapose6d_tpu_torch.ops import rasterizer_tiled as rt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def world(device, faces=(512, 128)):
    objects = RigidObjectDataset([RigidObject(label="obj1", mesh=mesh_io.make_uv_sphere(0.05, 20, 20)),
                                  RigidObject(label="obj2", mesh=mesh_io.make_cube(0.04))])
    return [MeshDataBase.from_object_ds(objects, max_faces=f, n_points=200, n_sym=4).batched(device=device)
            for f in faces]


def request(device, n=3):
    K = np.asarray([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(0)
    img = rng.uniform(size=(1, 240, 320, 3)).astype(np.float32)
    half = 300 * 0.05 / 0.55
    c = np.stack([160 + rng.uniform(-20, 20, n), 120 + rng.uniform(-20, 20, n)], 1)
    boxes = np.concatenate([c - half, c + half], 1).astype(np.float32)
    return (ObservationTensor(torch.as_tensor(img, device=device), torch.as_tensor(K[None], device=device)),
            make_detections(["obj1", "obj2", "obj1"][:n], boxes, device=device))


def test_graph_replay_equals_eager(cuda):
    db, lod = world(cuda)
    coarse = tpp.build_pose_predictor(tpp.make_coarse_config(render_size=(120, 160), backbone="resnet18-spatial",
                                                             compute_dtype="bfloat16"), 0, cuda)
    refiner = tpp.build_pose_predictor(tpp.make_refiner_config(
        render_size=(120, 160), backbone="resnet18-spatial", n_rendered_views=2,
        multiview_type="TCO+front_1view", compute_dtype="bfloat16"), 1, cuda)
    cfg = InferenceConfig(SO3_grid_size=72, SO3_prune_grid_size=16, SO3_prune_keep=4, n_refiner_iterations=2,
                          n_pose_hypotheses=2, bsz_images=32, bsz_objects=4, max_detections=4,
                          fused_pipeline=True, coarse_render_size=(60, 80), rescore_f32=True)
    est = PoseEstimator(coarse, refiner, db, cfg, device=cuda, mesh_db_coarse=lod)
    obs, dets = request(cuda)
    before = rt.visibility_kernel.launches
    first, _ = est.run_inference_pipeline(obs, dets)
    graph = next(iter(est._graphs.values()))
    assert rt.visibility_kernel.launches - before == 2 * graph.kernel_launches > 0  # warm-up and capture
    again, extra = est.run_inference_pipeline(obs, dets)
    assert torch.equal(first.poses, again.poses) and graph.replays == 2 and len(est._graphs) == 1
    assert set(extra["timing"]) == {"total"}
    with torch.inference_mode():
        args, inputs = est.fused_inputs(obs.images, obs.K, dets.bboxes, db.label_to_index(dets.labels),
                                        cfg.n_refiner_iterations, cfg.n_pose_hypotheses)
        assert args == (32, 4, 2, 2) and inputs[2].shape[0] == 4
        replay = {k: v.clone() for k, v in est.fused(*args, *inputs).items()}
        eager = est.pipeline(*args, *inputs)
    for k in eager:
        assert torch.equal(replay[k], eager[k]), k
    torch.testing.assert_close(first.poses, eager["TCO_best"][:3], rtol=0, atol=0)


@pytest.mark.parametrize("hw,faces", [((120, 160), 768), ((120, 160), 512), ((240, 320), 512)])
def test_kernel_equals_plain_at_production_shapes(cuda, hw, faces):
    db = world(cuda, faces=(faces,))[0]
    assert db.faces.shape[1] == faces
    B = 48
    rng = np.random.RandomState(1)
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    q = rng.normal(size=(B, 4))
    from megapose6d_tpu_torch.ops.se3 import rotmat_from_quat

    TCO[:, :3, :3] = rotmat_from_quat(torch.as_tensor(q / np.linalg.norm(q, axis=1, keepdims=True),
                                                      dtype=torch.float32)).numpy()
    TCO[:, :3, 3] = np.stack([rng.normal(scale=0.01, size=B), rng.normal(scale=0.01, size=B),
                              rng.uniform(0.3, 0.6, B)], -1)
    K = np.tile(np.asarray([[hw[1], 0, hw[1] / 2], [0, hw[1], hw[0] / 2], [0, 0, 1]], np.float32), (B, 1, 1))
    m = db.select(torch.zeros(B, dtype=torch.long, device=cuda))
    _, coefs, ids, n_act = rt.prepare_render(
        m.vertices, m.normals, m.colors, m.faces, m.face_valid, torch.as_tensor(TCO, device=cuda),
        torch.as_tensor(K, device=cuda), hw, backface_cull=True)
    vis = (coefs, ids, n_act, hw)
    out_k, out_p = rt.visibility_kernel(*vis), rt.visibility_plain(*vis)
    assert (out_k[1] >= 0).any()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
