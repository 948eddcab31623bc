"""Port vs JAX: the depth path (`utils/threefry.py`, `ops/icp.py`,
`ops/registration.py`, `inference/depth_refiner.py`).

The same numpy inputs go through both packages on the CPU. Tolerances:
  - the threefry copy against `jax.random`: bit for bit;
  - `depth_to_xyz`: 1 ulp (rtol 2e-7); normals within 1e-5 (the two
    packages' cross products and norms round apart), NaN where JAX's are;
  - `_masked_sample_idx`: equal indices and validity;
  - ICP on a cube scene: 1e-3 degree and 1e-3 mm, equal `valid`; GNC-TLS
    on point sets with outliers: 1e-3 degree and 1e-3 mm; `kabsch`: 1e-5;
    farthest-point sampling: equal indices (the 6x6 normal equations and
    the 3x3 covariances are sums of 512 to 1024 terms, which XLA and torch
    order differently);
  - the refiners on committed `runs/ar_gnc/synthdemo` frames at perturbed
    ground-truth poses, each package rendering its own depth: equal
    `valid`; ICP 0.01 degree and 0.01 mm (f32 at 1 m is 1.2e-4 mm a
    step), GNC 0.05 degree and 0.05 mm; ICP on the sphere only `valid` and
    finite poses (see the conditioning test).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.ops import icp as jicp
from megapose6d_tpu.ops import registration as jreg
from megapose6d_tpu.ops import rasterizer as jras
from megapose6d_tpu.meshes import make_cube
from megapose6d_tpu_torch.ops import icp as ticp
from megapose6d_tpu_torch.ops import registration as treg
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.utils import threefry

ROOT = Path(__file__).resolve().parents[1]
AR_GNC = ROOT / "runs/ar_gnc"

H, W = 96, 128
K = np.asarray([[260.0, 0, W / 2 - 0.5], [0, 260.0, H / 2 - 0.5], [0, 0, 1]], np.float32)


def T_(x):
    return torch.as_tensor(np.asarray(x))


def rot_deg(Ra, Rb):
    """Angle between rotations, from |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2)
    (the trace form loses small angles to f32 rounding)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64), axis=(-2, -1))
    return np.degrees(2 * np.arcsin(np.clip(d / (2 * np.sqrt(2)), 0, 1)))


def assert_poses_close(a, b, deg, mm):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = rot_deg(a[..., :3, :3], b[..., :3, :3])
    t = np.abs(a[..., :3, 3] - b[..., :3, 3]).max(-1) * 1000
    assert d.max() <= deg and t.max() <= mm, (d, t)


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 123, 2**31 + 7])
def test_threefry_key_and_split(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(k), threefry.PRNGKey(seed))
    for n in (1, 2, 3, 19):
        np.testing.assert_array_equal(np.asarray(jax.random.split(k, n)),
                                      threefry.split(threefry.PRNGKey(seed), n))


@pytest.mark.parametrize("shape", [(120, 160), (240, 320), (7, 13), (1, 1), (1001,)])
def test_threefry_uniform_bit_for_bit(shape):
    for key in (jax.random.PRNGKey(0), *jax.random.split(jax.random.PRNGKey(5), 3)):
        a = np.asarray(jax.random.uniform(key, shape))
        b = threefry.uniform(np.asarray(key), shape)
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_threefry_refiner_keys():
    """The keys the refiners use: split(PRNGKey(0), N), then split again."""
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    for j, kj in enumerate(keys):
        k1, k2 = jax.random.split(kj)
        t1, t2 = threefry.split(threefry.split(threefry.PRNGKey(0), 2)[j])
        for a, b in ((k1, t1), (k2, t2)):
            np.testing.assert_array_equal(np.asarray(jax.random.uniform(a, (120, 160))),
                                          threefry.uniform(b, (120, 160)))


# ---------------------------------------------------------------------------
# ops/icp.py
# ---------------------------------------------------------------------------


def noisy_depth(rng, holes=True):
    d = (0.5 + 0.05 * rng.rand(H, W)).astype(np.float32)
    if holes:
        d[rng.rand(H, W) < 0.1] = 0.0
        d[rng.rand(H, W) < 0.02] = np.nan
    return d


def test_depth_to_xyz_and_normals(rng):
    d = noisy_depth(rng)
    a = np.asarray(jicp.depth_to_xyz(jnp.asarray(d), jnp.asarray(K)))
    b = ticp.depth_to_xyz(T_(d), T_(K)).numpy()
    np.testing.assert_allclose(b, a, rtol=2e-7, atol=0, equal_nan=True)
    na = np.asarray(jicp.depth_normals(jnp.asarray(d), jnp.asarray(K)))
    nb = ticp.depth_normals(T_(d), T_(K)).numpy()
    np.testing.assert_array_equal(np.isnan(na), np.isnan(nb))
    np.testing.assert_allclose(nb, na, atol=1e-5, equal_nan=True)
    # Batched: K per image.
    b2 = ticp.depth_to_xyz(T_(np.stack([d, d])), T_(np.stack([K, K])))
    assert torch.equal(b2[1].nan_to_num(), T_(b).nan_to_num())


@pytest.mark.parametrize("hw,n", [((120, 160), 1024), ((96, 128), 512), ((37, 53), 36), ((20, 30), 7)])
def test_masked_sample_idx_equal(rng, hw, n):
    mask = rng.rand(*hw) < 0.3
    mask[: hw[0] // 2] = False  # a half-empty image: empty cells too
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        ia, va = jicp._masked_sample_idx(key, jnp.asarray(mask), n)
        u = ticp.uniform_fields(np.asarray(key)[None], hw, "cpu")
        ib, vb = ticp._masked_sample_idx(u, T_(mask)[None], n)
        np.testing.assert_array_equal(np.asarray(ia), ib[0].numpy())
        np.testing.assert_array_equal(np.asarray(va), vb[0].numpy())


def test_masked_sample_idx_ties_to_the_first():
    """A field of ties (all-equal scores): both take the first index."""
    mask = np.ones((16, 16), bool)
    u = torch.zeros((1, 16, 16))
    idx, valid = ticp._masked_sample_idx(u, T_(mask)[None], 16)
    cells = np.arange(16 * 16).reshape(4, 4, 4, 4).transpose(1, 3, 0, 2).reshape(16, 16)
    np.testing.assert_array_equal(idx[0].numpy(), cells[:, 0])
    assert bool(valid.all())


def render_depth(mesh, T):
    out = jras.render_meshes(
        jnp.asarray(mesh.vertices)[None], jnp.asarray(mesh.vertex_normals)[None],
        jnp.asarray(mesh.vertex_colors)[None], jnp.asarray(mesh.faces)[None],
        jnp.ones((1, mesh.n_faces), bool), jnp.asarray(T, jnp.float32)[None],
        jnp.asarray(K)[None], (H, W))
    return np.asarray(out.depth[0])


@pytest.fixture(scope="module")
def cube_scene():
    """Measured depth of a cube showing three faces at T_gt, and renders
    at two offset poses."""
    cube = make_cube(0.06)
    T_gt = random_T(np.random.RandomState(3), deg=35.0, trans=0.0)
    T_gt[:3, 3] = [0.01, -0.005, 0.5]
    preds = []
    for off, deg in (([0.012, 0.008, 0.02], 4.0), ([-0.006, 0.004, -0.01], 2.0)):
        T = T_gt.copy()
        T[:3, :3] = random_T(np.random.RandomState(int(deg)), deg=deg)[:3, :3] @ T[:3, :3]
        T[:3, 3] += off
        preds.append(T)
    measured = render_depth(cube, T_gt)
    rendered = np.stack([render_depth(cube, T) for T in preds])
    return measured, rendered, np.stack(preds)


@pytest.mark.parametrize("nan_pixels", [False, True])
def test_icp_refine_pose_matches_jax(cube_scene, nan_pixels):
    """Two objects at once, with and without NaN sensor dropouts inside
    the silhouette (the case of `tests/test_icp.py`'s NaN test)."""
    pin_f32()
    measured, rendered, TCO = cube_scene
    measured = measured.copy()
    if nan_pixels:
        ys, xs = np.where(measured > 0)
        measured[ys[:: max(1, len(ys) // 40)], xs[:: max(1, len(xs) // 40)]] = np.nan
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    fn = jax.jit(jax.vmap(lambda k, dr: jicp.icp_refine_pose(
        k, jnp.eye(4), jnp.asarray(measured), dr, jnp.asarray(K), n_points=512, n_iterations=25)))
    ja = fn(keys, jnp.asarray(rendered))
    tb = ticp.icp_refine_pose(np.asarray(keys), None, T_(measured), T_(rendered), T_(K),
                              n_points=512, n_iterations=25)
    np.testing.assert_array_equal(np.asarray(ja.valid), tb.valid.numpy())
    assert bool(tb.valid.all()) and torch.isfinite(tb.T_delta).all()
    assert_poses_close(np.asarray(ja.T_delta) @ TCO, tb.T_delta.numpy() @ TCO, 1e-3, 1e-3)
    np.testing.assert_allclose(tb.residual.numpy(), np.asarray(ja.residual), rtol=1e-3, atol=1e-7)


def first_normal_equations(mesh, T_gt, offset):
    """JᵀJ of ICP's first step (512 points, the refiners' sampling) for a
    render of `mesh` at `T_gt + offset` against its render at `T_gt`."""
    T = T_gt.copy()
    T[:3, 3] += offset
    dm, dr = render_depth(mesh, T_gt), render_depth(mesh, T)
    xyz_t = ticp.depth_to_xyz(T_(dm), T_(K)).reshape(-1, 3)
    nrm_t = ticp.depth_normals(T_(dm), T_(K)).reshape(-1, 3)
    xyz_s = ticp.depth_to_xyz(T_(dr), T_(K)).reshape(-1, 3)
    keys = threefry.split(threefry.split(threefry.PRNGKey(0), 1)[0])
    si, _ = ticp._masked_sample_idx(ticp.uniform_fields(keys[:1], (H, W), "cpu"), T_(dr > 0)[None], 512)
    ti, _ = ticp._masked_sample_idx(ticp.uniform_fields(keys[1:], (H, W), "cpu"),
                                    T_((dm > 0.2) & (dr > 0))[None], 512)
    p, q, n = xyz_s[si[0]].double(), xyz_t[ti[0]].double(), nrm_t[ti[0]].double()
    p = p + (q.mean(0) - p.mean(0))
    n = n[((p[:, None] - q[None]) ** 2).sum(-1).argmin(1)]
    J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], -1)
    J = J[torch.isfinite(J).all(-1)]
    return J.T @ J


def test_icp_normal_equations_of_a_sphere_are_ill_conditioned(cube_scene):
    """Why ICP on a sphere is not held per pose: rotating a sphere about
    its centre leaves its surface in place, so JᵀJ is nearly singular
    (measured: condition number ~1.2e5, against ~1.8e3 for the cube
    scene); a relative rounding of 1e-7 in its entries moves the solution
    by ~1e-2 relative."""
    from megapose6d_tpu.meshes import make_uv_sphere

    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, 3] = [0.01, -0.005, 0.5]
    sphere = torch.linalg.cond(first_normal_equations(make_uv_sphere(0.05, 16, 24), T_gt, [0.012, 0.008, 0.02]))
    Tc = random_T(np.random.RandomState(3), deg=35.0, trans=0.0)
    Tc[:3, 3] = [0.01, -0.005, 0.5]
    cube = torch.linalg.cond(first_normal_equations(make_cube(0.06), Tc, [0.012, 0.008, 0.02]))
    assert sphere > 3e4 and cube < 1e4, (sphere, cube)


def test_icp_point_to_plane_matches_jax(rng):
    """Direct call with invalid slots on both sides; fewer than 11 valid
    source points make the result invalid (identity)."""
    pin_f32()
    n = 256
    src = (rng.randn(2, n, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32)
    R = np.asarray(jax.numpy.asarray(np.eye(3)), np.float32)
    tgt = (src @ R.T + [0.004, -0.003, 0.002]).astype(np.float32)
    nrm = rng.randn(2, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    sv = rng.rand(2, n) < 0.9
    sv[1, 10:] = False
    tv = rng.rand(2, n) < 0.9
    ja = jax.vmap(lambda *a: jicp.icp_point_to_plane(*a, n_iterations=10))(
        *(jnp.asarray(x) for x in (src, tgt, nrm, sv, tv)))
    tb = ticp.icp_point_to_plane(*(T_(x) for x in (src, tgt, nrm, sv, tv)), n_iterations=10)
    np.testing.assert_array_equal(np.asarray(ja.valid), tb.valid.numpy())
    assert tb.valid.tolist() == [True, False]
    assert torch.equal(tb.T_delta[1], torch.eye(4))
    assert_poses_close(ja.T_delta, tb.T_delta.numpy(), 1e-3, 1e-3)


# ---------------------------------------------------------------------------
# ops/registration.py
# ---------------------------------------------------------------------------


def random_T(rng, deg=25.0, trans=0.08):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx
    T[:3, 3] = rng.randn(3) * trans
    return T


def test_kabsch_matches_jax(rng):
    src = rng.randn(3, 60, 3).astype(np.float32) * 0.1
    w = rng.rand(3, 60).astype(np.float32)
    Ts = np.stack([random_T(rng) for _ in range(3)])
    tgt = (np.einsum("bij,bnj->bni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]).astype(np.float32)
    tgt += rng.randn(*tgt.shape).astype(np.float32) * 1e-3
    ja = jax.vmap(jreg.kabsch)(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    tb = treg.kabsch(T_(src), T_(tgt), T_(w))
    np.testing.assert_allclose(tb.numpy(), np.asarray(ja), atol=1e-5)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.4])
def test_gnc_tls_matches_jax(rng, outlier_frac):
    N = 300
    src = (rng.randn(2, N, 3) * 0.1).astype(np.float32)
    Ts = np.stack([random_T(rng) for _ in range(2)])
    tgt = (np.einsum("bij,bnj->bni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]).astype(np.float32)
    tgt += rng.randn(*tgt.shape).astype(np.float32) * 1e-3
    n_out = int(N * outlier_frac)
    tgt[:, :n_out] += rng.randn(2, n_out, 3).astype(np.float32) * 0.3
    valid = rng.rand(2, N) < 0.95
    src[0, 5] = np.nan  # a NaN slot is zeroed and dropped
    ja = jax.vmap(lambda s, t, v: jreg.gnc_tls_registration(s, t, v, noise_bound=0.005))(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid))
    tb = treg.gnc_tls_registration(T_(src), T_(tgt), T_(valid), noise_bound=0.005)
    np.testing.assert_array_equal(np.asarray(ja.valid), tb.valid.numpy())
    np.testing.assert_array_equal(np.asarray(ja.inliers), tb.inliers.numpy())
    np.testing.assert_array_equal(np.asarray(ja.n_inliers), tb.n_inliers.numpy())
    assert_poses_close(ja.T_tgt_src, tb.T_tgt_src.numpy(), 1e-3, 1e-3)
    assert_poses_close(Ts, tb.T_tgt_src.numpy(), 1.0, 2.0)


def test_gnc_too_few_points_is_invalid(rng):
    src = rng.randn(1, 20, 3).astype(np.float32)
    valid = np.zeros((1, 20), bool)
    valid[0, :5] = True
    tb = treg.gnc_tls_registration(T_(src), T_(src), T_(valid))
    assert not bool(tb.valid[0]) and torch.equal(tb.T_tgt_src[0], torch.eye(4))


@pytest.mark.parametrize("with_key", [False, True])
def test_sample_farthest_points_matches_jax(rng, with_key):
    pts = rng.randn(200, 3).astype(np.float32)
    valid = rng.rand(200) < 0.8
    key = jax.random.PRNGKey(4) if with_key else None
    ja = jreg.sample_farthest_points(jnp.asarray(pts), 32, jnp.asarray(valid), key=key)
    tb = treg.sample_farthest_points(T_(pts), 32, T_(valid),
                                     key=None if key is None else np.asarray(key))
    np.testing.assert_array_equal(np.asarray(ja), tb.numpy())


# ---------------------------------------------------------------------------
# inference/depth_refiner.py on committed frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_type", ["simple", "threshold"])
def test_compute_masks(rng, mask_type):
    from megapose6d_tpu.inference.depth_refiner import compute_masks as jmasks
    from megapose6d_tpu_torch.inference.depth_refiner import compute_masks as tmasks

    dr = np.where(rng.rand(H, W) < 0.5, 0, rng.rand(H, W)).astype(np.float32)
    dm = np.where(rng.rand(H, W) < 0.2, 0, dr + 0.2 * rng.randn(H, W)).astype(np.float32)
    a = np.asarray(jmasks(mask_type, jnp.asarray(dr), jnp.asarray(dm)))
    np.testing.assert_array_equal(tmasks(mask_type, T_(dr), T_(dm)).numpy(), a)
    with pytest.raises(ValueError):
        tmasks("other", T_(dr), T_(dm))


def perturbed(T, rng, deg=4.0, trans=0.008):
    P = random_T(rng, deg, 0.0)
    out = T.astype(np.float32).copy()
    out[:3, :3] = P[:3, :3] @ out[:3, :3]
    out[:3, 3] += rng.randn(3) * trans
    return out


@pytest.fixture(scope="module")
def refiner_inputs():
    """Two committed frames of runs/ar_gnc/synthdemo, their ground truth
    perturbed from a seed, and both packages' mesh databases built as
    `demo_ar_baseline` builds its world (2048 faces, 512 points, 4
    symmetries)."""
    from megapose6d_tpu.data.bop_scene_dataset import load_bop_object_dataset as jload
    from megapose6d_tpu.meshes import MeshDataBase as JDB
    from megapose6d_tpu_torch.data.bop_scene_dataset import load_bop_object_dataset as tload
    from megapose6d_tpu_torch.data.datasets_cfg import make_scene_dataset
    from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase as TDB

    kw = dict(max_faces=2048, n_points=512, n_sym=4)
    jdb = JDB.from_object_ds(jload(AR_GNC / "synthdemo/models"), **kw).batched()
    tdb = TDB.from_object_ds(tload(AR_GNC / "synthdemo/models"), **kw).batched(device="cpu")
    ds = make_scene_dataset("synthdemo.bop19", load_depth=True, data_dir=AR_GNC)
    rng = np.random.RandomState(7)
    frames = []
    for i in (0, 5):
        obs = ds[i]
        objs = obs.gt_detections()
        poses = np.stack([perturbed(o.TWO, rng) for o in objs])
        frames.append((obs.depth.astype(np.float32), obs.camera_data.K.astype(np.float32),
                       [o.label for o in objs], poses))
    return jdb, tdb, frames


def test_depth_renders_match_jax():
    """The refiners' renders (120x160, untextured, no cull) of all 10
    ar_gnc frames at perturbed ground truth, each package its own: the
    two phase A's round the 1/z planes apart, which could flip a
    silhouette pixel and so move one sampled point. Measured: no flipped
    pixel; depth medians up to 5.4e-6 m and single pixels up to 2.7e-4 m
    apart (the sphere's small faces). Held: at most 2 flipped pixels a
    frame, medians within 1e-5 m as `tests/test_torch_rasterizer.py`
    holds its sphere, every pixel within 1e-3 m."""
    from megapose6d_tpu.data.bop_scene_dataset import load_bop_object_dataset as jload
    from megapose6d_tpu.meshes import MeshDataBase as JDB
    from megapose6d_tpu.ops import rasterizer_tiled as jrt
    from megapose6d_tpu_torch.data.datasets_cfg import make_scene_dataset
    from megapose6d_tpu_torch.inference.depth_refiner import ICPRefiner
    from megapose6d_tpu_torch.scripts.demo_ar_baseline import world_mesh_db

    jdb = JDB.from_object_ds(jload(AR_GNC / "synthdemo/models"), max_faces=2048, n_points=512, n_sym=4).batched()
    tref = ICPRefiner(world_mesh_db(AR_GNC / "synthdemo", "cpu"))
    ds = make_scene_dataset("synthdemo.bop19", data_dir=AR_GNC)
    rng = np.random.RandomState(0)
    render = jax.jit(lambda m, T, K_: jrt.render_meshes_tiled(
        m.vertices, m.normals, m.colors, m.faces, m.face_valid, T, K_, (120, 160), interpret=True).depth)
    flips = []
    for i in range(len(ds)):
        obs = ds[i]
        objs = obs.gt_detections()
        labels = [o.label for o in objs]
        poses = np.stack([perturbed(o.TWO, rng) for o in objs])
        Kr = obs.camera_data.K.astype(np.float32).copy()
        Kr[:2] /= 2
        a = np.asarray(render(jdb.select(jdb.label_to_index(labels)), jnp.asarray(poses),
                              jnp.broadcast_to(jnp.asarray(Kr), (len(labels), 3, 3))))
        b = tref.render_depth(T_(poses), tref.mesh_db.label_to_index(labels), T_(Kr), (120, 160)).numpy()
        flips.append(int(((a > 0) != (b > 0)).sum()))
        both = (a > 0) & (b > 0)
        d = np.abs(a - b)[both]
        assert d.max() <= 1e-3 and np.median(d) <= 1e-5
    assert max(flips) <= 2, flips


SPHERE = "obj_000002"  # the textured UV sphere of runs/ar_gnc/synthdemo/models


@pytest.mark.parametrize("kind", ["icp", "gnc"])
def test_refiners_on_committed_frames_match_jax(refiner_inputs, kind):
    """Frame 0 shows two spheres, frame 5 two cubes. Point-to-plane ICP
    cannot observe a sphere's rotation about its centre
    (`test_icp_normal_equations_of_a_sphere_are_ill_conditioned`), so
    rounding steers that solve, in each package on its own too (a start
    shifted by 1 um can end centimetres away); for the sphere under ICP
    only `valid` and finite poses are held."""
    import pandas as pd
    from megapose6d_tpu.data.tensor_collection import PandasTensorCollection
    from megapose6d_tpu.inference import depth_refiner as jdr
    from megapose6d_tpu_torch.data.tensor_collection import TensorCollection
    from megapose6d_tpu_torch.inference import depth_refiner as tdr

    pin_f32()
    jdb, tdb, frames = refiner_inputs
    cls = {"icp": "ICPRefiner", "gnc": "GNCRegistrationRefiner"}[kind]
    jref, tref = getattr(jdr, cls)(jdb), getattr(tdr, cls)(tdb)
    for depth, K_, labels, poses in frames:
        jout, jx = jref.refine_poses(
            PandasTensorCollection(pd.DataFrame({"label": labels}), poses=poses), depth=depth, K=K_)
        tout, tx = tref.refine_poses(TensorCollection(labels, poses=T_(poses)), depth=T_(depth), K=T_(K_))
        np.testing.assert_array_equal(jx["valid"], tx["valid"].numpy())
        assert bool(tx["valid"].all())
        a, b = np.asarray(jout.poses), tout.poses.numpy()
        deg = rot_deg(a[:, :3, :3], b[:, :3, :3])
        mm = np.abs(a[:, :3, 3] - b[:, :3, 3]).max(-1) * 1000
        loose = np.array([kind == "icp" and l == SPHERE for l in labels])
        tight = (0.01, 0.01) if kind == "icp" else (0.05, 0.05)
        assert np.isfinite(b).all()
        assert (deg[~loose] <= tight[0]).all() and (mm[~loose] <= tight[1]).all(), (deg, mm)
        moved = rot_deg(poses[:, :3, :3], b[:, :3, :3]) + np.abs(poses[:, :3, 3] - b[:, :3, 3]).max(-1)
        assert (moved > 1e-3).all()  # the refiner did change the poses
        if kind == "gnc":
            np.testing.assert_array_equal(np.asarray(jx["n_inliers"]), tx["n_inliers"].numpy())
        else:
            np.testing.assert_allclose(tx["residual"].numpy()[~loose], np.asarray(jx["residual"])[~loose],
                                       rtol=1e-3)


def test_refiner_keeps_the_pose_without_depth_points(refiner_inputs):
    """No measured depth: every solve is invalid and the RGB pose stays."""
    from megapose6d_tpu_torch.data.tensor_collection import TensorCollection
    from megapose6d_tpu_torch.inference.depth_refiner import GNCRegistrationRefiner, ICPRefiner

    _, tdb, frames = refiner_inputs
    depth, K_, labels, poses = frames[0]
    for cls in (ICPRefiner, GNCRegistrationRefiner):
        out, extra = cls(tdb).refine_poses(TensorCollection(labels, poses=T_(poses)),
                                           depth=torch.zeros(depth.shape), K=T_(K_))
        assert not bool(extra["valid"].any())
        assert torch.equal(out.poses, T_(poses))
