"""The CUDA visibility kernel against its plain torch twin, on the card.

Skipped without a CUDA device. On the card (no JAX there, so without the
repository's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_visibility_cuda.py

The kernel repeats the twin's arithmetic operation for operation, so face
ids and background must be equal and 1/z and attributes bit-identical. The
kernel also skips, per warp of 4x32 pixels, faces that provably cover none
of its pixels; the cases below put edges where that test is tightest.
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


def tables(device, B, hw, mesh, seed=0, center=None):
    rng = np.random.RandomState(seed)
    rep = lambda a: torch.as_tensor(np.repeat(np.asarray(a)[None], B, 0), device=device)
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, B)
    TCO[:, 0, 0], TCO[:, 0, 2], TCO[:, 2, 0], TCO[:, 2, 2] = np.cos(ang), np.sin(ang), -np.sin(ang), np.cos(ang)
    TCO[:, :3, 3] = np.stack([rng.normal(scale=0.01, size=B), rng.normal(scale=0.01, size=B),
                              rng.uniform(0.3, 0.5, B)], -1)
    cx, cy = center if center is not None else (hw[1] / 2 - 0.5, hw[0] / 2 - 0.5)
    K = np.tile(np.asarray([[200.0, 0, cx], [0, 200.0, cy], [0, 0, 1]], np.float32), (B, 1, 1))
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
    vis = tables(cuda, B, hw, mesh) + (hw,)
    before = rt.visibility_kernel.launches
    out = rt.visibility(*vis)
    torch.cuda.synchronize()
    assert rt.visibility_kernel.launches == before + 1
    assert (out[1] >= 0).any()
    assert_identical(out, rt.visibility_plain(*vis))


def test_kernel_equals_plain_above_the_segment_cap(cuda):
    """A 34,040-face sphere (the TPU kernel takes at most 8192 faces a
    program and renders larger meshes in segments) at 3 hypotheses: one
    launch over all faces, bit-identical to the plain twin."""
    mesh = mesh_io.make_uv_sphere(0.05, 116, 148)
    assert mesh.n_faces > 4 * 8192
    vis = tables(cuda, 3, (240, 320), mesh, seed=4) + ((240, 320),)
    before = rt.visibility_kernel.launches
    out = rt.visibility(*vis)
    torch.cuda.synchronize()
    assert rt.visibility_kernel.launches == before + 1
    assert (out[1] >= 0).sum() > 3 * 1000
    assert_identical(out, rt.visibility_plain(*vis))


def test_kernel_empty_tiles_and_nan_planes(cuda):
    mesh = mesh_io.make_cube(0.05)
    coefs, ids, n_act = tables(cuda, 2, (64, 64), mesh)
    n_act[1] = 0  # nothing active in image 1
    coefs[0, :16, 9:12] = float("nan")  # NaN 1/z planes void the chunk where it covers
    vis = (coefs, ids, n_act, (64, 64))
    out = rt.visibility_kernel(*vis)
    assert_identical(out, rt.visibility_plain(*vis))
    assert (out[1][1] == -1).all()


def test_kernel_refuses_bad_inputs(cuda):
    coefs, ids, n_act = tables(cuda, 1, (64, 64), mesh_io.make_cube(0.05))
    with pytest.raises(ValueError):
        rt.visibility_kernel(coefs.double(), ids, n_act, (64, 64))
    with pytest.raises(ValueError):
        rt.visibility_kernel(coefs, ids, n_act, (64, 96))  # tables of another tiling
    with pytest.raises(ValueError):
        rt.visibility_kernel(coefs.cpu(), ids, n_act, (64, 64))
    with pytest.raises(ValueError):
        rt.visibility_kernel(coefs, ids, n_act, (64, 64), split=rt.MAX_SPLIT + 1)


def screen_tables(device, tri_uv, hw, seed=0):
    """Phase A tables of triangles given in pixel coordinates, `tri_uv`
    `[B, F, 3, 2]`, at random depths in [1, 2]."""
    rng = np.random.RandomState(seed)
    B, F = tri_uv.shape[:2]
    z = rng.uniform(1.0, 2.0, size=(B, F, 3, 1))
    screen = np.concatenate([tri_uv, z], -1).reshape(B, F * 3, 3).astype(np.float32)
    normals = rng.normal(size=screen.shape).astype(np.float32)
    colors = rng.uniform(size=screen.shape).astype(np.float32)
    faces = np.tile(np.arange(F * 3, dtype=np.int32).reshape(1, F, 3), (B, 1, 1))
    t = lambda a: torch.as_tensor(a, device=device)
    valid = torch.ones((B, F), dtype=torch.bool, device=device)
    return rt.prepare(t(screen), t(normals), t(colors), t(faces), valid, hw, 0.01)


def test_kernel_equals_plain_on_slivers(cuda):
    """Long triangles a thousandth to half a pixel wide, at every angle:
    the faces whose edges pass nearest to the most pixel centres."""
    rng = np.random.RandomState(1)
    hw, B, F = (96, 160), 4, 512
    p0 = rng.uniform([-10, -10], [hw[1] + 10, hw[0] + 10], size=(B, F, 2))
    ang = rng.uniform(0, 2 * np.pi, size=(B, F, 1))
    d = np.concatenate([np.cos(ang), np.sin(ang)], -1)
    length = rng.uniform(5, 120, size=(B, F, 1))
    width = 10.0 ** rng.uniform(-3, np.log10(0.5), size=(B, F, 1))
    p1 = p0 + d * length
    p2 = p1 + np.concatenate([-d[..., 1:], d[..., :1]], -1) * width
    vis = screen_tables(cuda, np.stack([p0, p1, p2], 2), hw) + (hw,)
    out = rt.visibility_kernel(*vis)
    assert (out[1] >= 0).sum() > 1000
    assert_identical(out, rt.visibility_plain(*vis))


def test_kernel_equals_plain_on_footprint_borders(cuda):
    """Triangles with integer vertices on the rows and columns that bound
    the warps' 4x32 footprints, the 16x32 tiles and the 32x128 rebasing
    cells: their edges run exactly through pixel centres on those borders
    (edge value exactly 0, which is inside)."""
    rng = np.random.RandomState(2)
    hw, B, F = (64, 256), 3, 256
    ys = np.array([y for k in range(0, 65, 4) for y in (k - 1, k) if 0 <= y < 64] + [-3, 70], float)
    xs = np.array([x for k in range(0, 257, 32) for x in (k - 1, k) if 0 <= x < 256] + [-5, 300], float)
    tri = np.stack([rng.choice(xs, size=(B, F, 3)), rng.choice(ys, size=(B, F, 3))], -1)
    # Half of them are the two halves of border-aligned rectangles, whose
    # shared diagonal and sides pass through pixel centres.
    x0, x1 = np.sort(rng.choice(xs, size=(2, B, F // 4)), 0)
    y0, y1 = np.sort(rng.choice(ys, size=(2, B, F // 4)), 0)
    a, b, c, d = (np.stack(p, -1) for p in ((x0, y0), (x1, y0), (x1, y1), (x0, y1)))
    tri[:, : F // 2] = np.concatenate([np.stack([a, b, c], 2), np.stack([a, c, d], 2)], 1)
    vis = screen_tables(cuda, tri, hw, seed=3) + (hw,)
    out = rt.visibility_kernel(*vis)
    assert (out[1] >= 0).sum() > 1000
    assert_identical(out, rt.visibility_plain(*vis))


def test_kernel_equals_plain_across_rebasing_cells(cuda):
    """A sphere whose silhouette straddles the corner of four 32x128
    rebasing cells (the principal point between columns 127 and 128 and
    rows 31 and 32)."""
    mesh = mesh_io.make_uv_sphere(0.05, 20, 30)
    hw = (96, 256)
    vis = tables(cuda, 5, hw, mesh, center=(127.5, 31.5)) + (hw,)
    out = rt.visibility_kernel(*vis)
    fid = out[1]
    assert (fid[:, :32, :128] >= 0).any() and (fid[:, 32:, 128:] >= 0).any()
    assert_identical(out, rt.visibility_plain(*vis))


def test_kernel_refuses_other_chunks(cuda):
    """The chunk is 16 faces everywhere: tables whose face count is not a
    multiple of it, or whose chunk lists count chunks of another size, are
    refused, never rendered another way."""
    tri = np.random.RandomState(4).uniform(0, 64, size=(1, 64, 3, 2))
    coefs, ids, n_act = screen_tables(cuda, tri, (64, 64))
    before = rt.visibility_kernel.launches
    with pytest.raises(ValueError):
        rt.visibility_kernel(coefs[:, :56].contiguous(), ids, n_act, (64, 64))  # 56 faces
    with pytest.raises(ValueError):
        rt.visibility(coefs, torch.cat([ids, ids], -1), n_act, (64, 64))  # chunks of 8
    assert rt.visibility_kernel.launches == before


@pytest.mark.parametrize("split", [1, 2, 3, 7, 8, 16])
@pytest.mark.parametrize("hw,B", [((120, 160), 2), ((240, 320), 2)])
def test_kernel_split_equals_plain(cuda, hw, B, split):
    """Each tile's chain split over a cluster of `split` blocks (forced
    here; a launch picks it with `split_for`): bit for bit the plain twin,
    which walks the chain whole, also with ties of 1/z across parts (two
    copies of each face, one chunk apart), NaN chunks and empty tiles."""
    mesh = mesh_io.make_uv_sphere(0.05, 40, 60)
    coefs, ids, n_act = tables(cuda, B, hw, mesh, seed=split)
    vis = (coefs, ids, n_act, hw)
    before = rt.visibility_kernel.launches
    assert_identical(rt.visibility_kernel(*vis, split=split), rt.visibility_plain(*vis))
    assert rt.visibility_kernel.launches == before + 1
    # Every face twice, the copies in neighbouring chunks of one list.
    F = coefs.shape[1]
    twin = torch.stack([coefs.reshape(B, -1, 16, 32)] * 2, 2).reshape(B, 2 * F, 32).contiguous()
    twin_ids = torch.stack([2 * ids, 2 * ids + 1], -1).reshape(B, ids.shape[1], -1).contiguous()
    twin_vis = (twin, twin_ids, 2 * n_act, hw)
    assert_identical(rt.visibility_kernel(*twin_vis, split=split), rt.visibility_plain(*twin_vis))
    nan = coefs.clone()
    nan[:, 16:32, 9:12] = float("nan")
    n_empty = n_act.clone()
    n_empty[:, ::3] = 0
    odd = (nan, ids, n_empty, hw)
    assert_identical(rt.visibility_kernel(*odd, split=split), rt.visibility_plain(*odd))
