"""The visibility kernel's per-warp face cull is sound.

The CUDA kernel skips, for each warp of 4x32 pixels, the faces of a chunk
that one of their edge planes shows to miss all of those pixels.
`rasterizer_tiled.cull_plain` repeats that test in torch, with the same
arithmetic and footprints. Here every face it skips for a warp is
evaluated at each of the warp's pixels, as phase B evaluates it (planes
rebased to their 32x128 cell, every product and sum rounded to f32): none
may pass the inside test. The cases are planes that hypothesis draws,
among them planes through pixel centres on footprint corners and planes
with NaN, infinite and huge coefficients, and the cube, a UV sphere and the
BOP model obj_000002 at random poses.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from megapose6d_tpu_torch.meshes import io as mesh_io
from megapose6d_tpu_torch.ops import rasterizer_tiled as rt
from megapose6d_tpu_torch.ops._precision import pin_f32

pin_f32()
ROOT = Path(__file__).resolve().parents[1]
HW = (64, 256)  # 2x2 rebasing cells, 4x8 tiles, 128 warp footprints
N_WARPS = rt.TILE_H // rt.WARP_ROWS


def inside_anywhere(coefs, chunk_ids, n_active, resolution):
    """`[B, T, n, 16, warps]` bool: face j of the tile's i-th chunk passes
    the inside test at some pixel of the warp's footprint, computed as
    `visibility_plain` computes it."""
    B, F, _ = coefs.shape
    T = chunk_ids.shape[1]
    n_tw = -(-resolution[1] // rt.TILE_W)
    n = int(n_active.max())
    t = torch.arange(T)
    tile_row0, tile_col0 = (t // n_tw) * rt.TILE_H, (t % n_tw) * rt.TILE_W
    row0 = tile_row0 // rt.REBASE_HW[0] * rt.REBASE_HW[0]
    col0 = tile_col0 // rt.REBASE_HW[1] * rt.REBASE_HW[1]
    cf = coefs.reshape(B, F // 16, 16, rt.COEF_W)[torch.arange(B)[:, None, None], chunk_ids[:, :, :n].long()]
    a, b, c = cf[..., 0:9:3], cf[..., 1:9:3], cf[..., 2:9:3]  # [B, T, n, 16, 3]
    bc = lambda x: x.float()[None, :, None, None, None]
    c = c + a * bc(col0) + b * bc(row0)
    # Pixels of each warp: u [T, 1, 32], v [T, warps, 4] in local coordinates.
    u = ((tile_col0 - col0)[:, None] + torch.arange(rt.TILE_W)).float()[:, None, None, :]
    v = ((tile_row0 - row0)[:, None, None] + torch.arange(rt.TILE_H).reshape(N_WARPS, rt.WARP_ROWS))
    v = v.float()[..., None]  # [T, warps, 4, 1]
    inside = True
    for k in range(3):  # [B, T, n, 16, warps, 4, 32]
        ak, bk, ck = (x[..., k, None, None, None] for x in (a, b, c))
        inside = inside & ((ak * u[None, :, None, None] + bk * v[None, :, None, None]) + ck >= 0)
    return inside.flatten(-2).any(-1)


def assert_cull_sound(coefs, chunk_ids, n_active, resolution, min_skipped=1):
    live = rt.cull_plain(coefs, chunk_ids, n_active, resolution)
    active = (torch.arange(live.shape[2]) < n_active[..., None])[..., None, None].expand_as(live)
    hit = inside_anywhere(coefs, chunk_ids, n_active, resolution)
    bad = hit & ~live & active
    assert not bad.any(), f"{int(bad.sum())} skipped (face, warp) pairs cover a pixel"
    assert int((active & ~live).sum()) >= min_skipped
    return live, active


def one_face_tables(a, b, c):
    """A chunk whose face 0 has edge 0 = (a, b, c) and two edges that hold
    everywhere (a = b = 0, c = 1), the other 15 faces neutral, active in
    every tile of `HW`."""
    coefs = torch.zeros((1, 16, rt.COEF_W))
    coefs[0, :, 2] = -1e30  # neutral rows
    coefs[0, 0, 0:9] = torch.tensor([a, b, c, 0, 0, 1, 0, 0, 1], dtype=torch.float32)
    T = (HW[0] // rt.TILE_H) * (HW[1] // rt.TILE_W)
    return coefs, torch.zeros((1, T, 1), dtype=torch.int32), torch.ones((1, T), dtype=torch.int32)


f32 = lambda lo, hi: st.floats(lo, hi, width=32)


@settings(max_examples=300, derandomize=True, deadline=None, database=None)
@given(
    a=f32(-1e3, 1e3), b=f32(-1e3, 1e3),
    px=st.integers(-3, HW[1] + 2), py=st.integers(-3, HW[0] + 2),
    shift=st.sampled_from([0.0, 1e-7, -1e-7, 1e-5, -1e-5, 1e-3, -1e-3, 0.3, -0.3]),
    scale=st.sampled_from([1.0, 1e-6, 1e6, 1e-30, 1e30]),
)
def test_cull_sound_for_planes_through_pixel_centres(a, b, px, py, shift, scale):
    """Edge lines through (or a hair off) a pixel centre, often a corner or
    border pixel of a footprint, at every slope and at scales from 1e-30
    to 1e30."""
    a, b = np.float32(a * scale), np.float32(b * scale)
    c = np.float32(-(np.float64(a) * px + np.float64(b) * py) + shift * scale)
    tables = one_face_tables(float(a), float(b), float(c))
    live, _ = assert_cull_sound(*tables, HW, min_skipped=0)
    assert not live[0, :, 0, 1:].any()  # the neutral rows are always skipped


@settings(max_examples=300, derandomize=True, deadline=None, database=None)
@given(a=st.floats(width=32), b=st.floats(width=32), c=st.floats(width=32))
def test_cull_sound_for_any_plane(a, b, c):
    """Any f32 coefficients: NaN, infinities, subnormals, huge values."""
    assert_cull_sound(*one_face_tables(a, b, c), HW, min_skipped=0)


def test_cull_skips_faces_beside_a_footprint():
    """A vertical edge that leaves a whole warp outside, one pixel column
    past the warp's last pixel centre, is skipped; the same edge through
    that pixel centre is not."""
    # edge value u - x: inside from column x on; tile 0 spans columns 0-31
    live_out = rt.cull_plain(*one_face_tables(1.0, 0.0, -32.0), HW)
    live_on = rt.cull_plain(*one_face_tables(1.0, 0.0, -31.0), HW)
    assert not live_out[0, 0, 0, 0].any() and live_out[0, 1, 0, 0].all()
    assert live_on[0, 0, 0, 0].all()


def random_poses(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = np.stack([rng.normal(scale=0.02, size=n), rng.normal(scale=0.02, size=n),
                            rng.uniform(0.2, 0.5, n)], -1)
    return T.astype(np.float32)


@pytest.mark.parametrize("name", ["cube", "uv_sphere", "obj_000002"])
def test_cull_sound_on_meshes(name):
    """Real tables: the chunks that phase A makes active in each 16x32
    tile of a 240x320 render at random poses."""
    mesh = {
        "cube": lambda: mesh_io.make_cube(0.05),
        "uv_sphere": lambda: mesh_io.make_uv_sphere(0.05, 16, 24),
        "obj_000002": lambda: mesh_io.load_ply(
            ROOT / "runs/ar_baseline/synthdemo/models/obj_000002.ply").scaled(0.001).with_computed_normals(),
    }[name]()
    rng = np.random.RandomState(5)
    B, hw = 3, (240, 320)
    colors = mesh.vertex_colors if mesh.vertex_colors is not None else np.full_like(mesh.vertices, 0.5)
    rep = lambda x: torch.as_tensor(np.repeat(np.asarray(x)[None], B, 0))
    K = np.asarray([[450.0, 0, 159.5], [0, 450.0, 119.5], [0, 0, 1]], np.float32)
    _, coefs, ids, n_act = rt.prepare_render(
        rep(mesh.vertices), rep(mesh.vertex_normals), rep(colors), rep(mesh.faces),
        torch.ones((B, mesh.n_faces), dtype=torch.bool), torch.as_tensor(random_poses(rng, B)),
        rep(K), hw)
    for i in range(B):
        one = (coefs[i : i + 1], ids[i : i + 1], n_act[i : i + 1])
        live, active = assert_cull_sound(*one, hw)
        # The cull has something to do: many active (face, warp) pairs miss.
        assert (active & ~live).sum() > 0.3 * active.sum()
