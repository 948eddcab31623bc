"""The CUDA visibility kernel against its plain torch twin, on the card.

Skipped without a CUDA device. On the card (no JAX there, so without the
repository's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_visibility_cuda.py

The kernel repeats the twin's arithmetic operation for operation, so face
ids and background must be equal and 1/z and attributes bit-identical.
"""

import numpy as np
import pytest
import torch

from megapose6d_tpu_torch.meshes import io as mesh_io
from megapose6d_tpu_torch.ops import rasterizer_tiled as rt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tables(device, B, hw, mesh, seed=0):
    rng = np.random.RandomState(seed)
    rep = lambda a: torch.as_tensor(np.repeat(np.asarray(a)[None], B, 0), device=device)
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, B)
    TCO[:, 0, 0], TCO[:, 0, 2], TCO[:, 2, 0], TCO[:, 2, 2] = np.cos(ang), np.sin(ang), -np.sin(ang), np.cos(ang)
    TCO[:, :3, 3] = np.stack([rng.normal(scale=0.01, size=B), rng.normal(scale=0.01, size=B),
                              rng.uniform(0.3, 0.5, B)], -1)
    K = np.tile(np.asarray([[200.0, 0, hw[1] / 2 - 0.5], [0, 200.0, hw[0] / 2 - 0.5], [0, 0, 1]],
                           np.float32), (B, 1, 1))
    valid = torch.ones((B, mesh.n_faces), dtype=torch.bool, device=device)
    _, coefs, ids, n_act = rt.prepare_render(
        rep(mesh.vertices), rep(mesh.vertex_normals), rep(mesh.vertex_colors), rep(mesh.faces),
        valid, torch.as_tensor(TCO, device=device), torch.as_tensor(K, device=device), hw,
        backface_cull=True)
    return coefs, ids, n_act


def assert_identical(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hw,B", [((240, 320), 7), ((50, 70), 3), ((96, 128), 1)])
def test_kernel_equals_plain(cuda, hw, B):
    mesh = mesh_io.make_uv_sphere(0.05, 20, 30)
    vis = tables(cuda, B, hw, mesh) + (hw, 16)
    before = rt.visibility_kernel.launches
    out = rt.visibility(*vis)
    torch.cuda.synchronize()
    assert rt.visibility_kernel.launches == before + 1
    assert (out[1] >= 0).any()
    assert_identical(out, rt.visibility_plain(*vis))


def test_kernel_empty_tiles_and_nan_planes(cuda):
    mesh = mesh_io.make_cube(0.05)
    coefs, ids, n_act = tables(cuda, 2, (64, 64), mesh)
    n_act[1] = 0  # nothing active in image 1
    coefs[0, :16, 9:12] = float("nan")  # NaN 1/z planes void the chunk where it covers
    vis = (coefs, ids, n_act, (64, 64), 16)
    out = rt.visibility_kernel(*vis)
    assert_identical(out, rt.visibility_plain(*vis))
    assert (out[1][1] == -1).all()


def test_kernel_refuses_bad_inputs(cuda):
    coefs, ids, n_act = tables(cuda, 1, (64, 64), mesh_io.make_cube(0.05))
    with pytest.raises(ValueError):
        rt.visibility_kernel(coefs.double(), ids, n_act, (64, 64), 16)
    with pytest.raises(ValueError):
        rt.visibility_kernel(coefs, ids, n_act, (64, 96), 16)  # tables of another tiling
    with pytest.raises(ValueError):
        rt.visibility_kernel(coefs.cpu(), ids, n_act, (64, 64), 16)
