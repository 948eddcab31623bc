"""Port vs JAX: the tiled rasterizer.

The JAX side runs `render_meshes_tiled(..., interpret=True)` (the Pallas
kernel interpreted on the CPU); the port runs phases A and C in torch and
phase B through `visibility_plain`, the CPU twin of the CUDA kernel.
Criteria follow `tests/test_rasterizer_tiled.py`: on the cube an identical
mask and atol 1e-4 on depth, rgb and normals; on the sphere mismatched
pixels only on the silhouette and a median depth error under 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from megapose6d_tpu.meshes import MeshDataBase as JMeshDataBase
from megapose6d_tpu.meshes import RigidObject as JRigidObject
from megapose6d_tpu.meshes import RigidObjectDataset as JRigidObjectDataset
from megapose6d_tpu.meshes import make_cube, make_uv_sphere
from megapose6d_tpu.ops import rasterizer_tiled as jrt
from megapose6d_tpu_torch.ops import rasterizer_tiled as trt
from megapose6d_tpu_torch.ops._precision import pin_f32

pin_f32()
H, W = 96, 128
K = np.asarray([[260.0, 0, W / 2 - 0.5], [0, 260.0, H / 2 - 0.5], [0, 0, 1]], np.float32)
CUBE_RX = [0.0, 0.5, 2.0]


def pose_z(z, rx=0.0):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(rx), np.sin(rx)
    T[:3, :3] = [[1, 0, 0], [0, c, -s], [0, s, c]]
    T[2, 3] = z
    return T


def mesh_args(mesh, TCO):
    B = len(TCO)
    rep = lambda a: np.repeat(np.asarray(a)[None], B, 0)
    return (
        rep(mesh.vertices), rep(mesh.vertex_normals), rep(mesh.vertex_colors),
        rep(mesh.faces), np.ones((B, mesh.n_faces), bool), np.asarray(TCO, np.float32),
        np.repeat(K[None], B, 0),
    )


def render_both(args, **kw):
    j = jrt.render_meshes_tiled(*map(jnp.asarray, args), (H, W), interpret=True, **kw)
    t = trt.render_meshes_tiled(*map(torch.as_tensor, args), (H, W), **kw)
    return ({k: np.asarray(v) for k, v in j._asdict().items()},
            {k: v.numpy() for k, v in t._asdict().items()})


@pytest.fixture(scope="module")
def cube_renders():
    """The three cube poses of test_rasterizer_tiled plus a non-finite
    pose, in one batch."""
    T_nan = pose_z(0.5)
    T_nan[0, 3] = np.nan
    TCO = [pose_z(0.5, rx) for rx in CUBE_RX] + [T_nan]
    return render_both(mesh_args(make_cube(0.05), TCO))


@pytest.mark.parametrize("i", range(len(CUBE_RX)))
def test_cube_matches_jax(cube_renders, i):
    j, t = cube_renders
    np.testing.assert_array_equal(j["mask"][i], t["mask"][i])
    assert t["mask"][i].any()
    for k in ("depth", "rgb", "normals"):
        np.testing.assert_allclose(j[k][i], t[k][i], atol=1e-4)


def test_nonfinite_pose_renders_empty(cube_renders):
    j, t = cube_renders
    assert not j["mask"][3].any() and not t["mask"][3].any()
    assert (t["depth"][3] == 0).all() and (t["rgb"][3] == 0).all()


def assert_silhouette_only(j, t):
    mj, mt = j["mask"][0], t["mask"][0]
    diff = mj != mt
    assert diff.mean() < 0.01, diff.mean()
    assert not (diff & ndimage.binary_erosion(mj, iterations=2)).any()
    m = mj & mt
    d = np.abs(j["depth"][0][m] - t["depth"][0][m])
    assert np.median(d) < 1e-5
    assert (d > 1e-3).mean() < 0.01


def test_sphere_matches_jax():
    j, t = render_both(mesh_args(make_uv_sphere(0.04, 16, 24), [pose_z(0.4)]))
    assert_silhouette_only(j, t)


def test_backface_cull_matches_jax():
    """A mesh-DB sphere (outward-CCW winding) with the cull on."""
    objs = JRigidObjectDataset([JRigidObject(label="s", mesh=make_uv_sphere(0.04, 12, 16))])
    db = JMeshDataBase.from_object_ds(objs, max_faces=512, n_points=64, n_sym=2).batched(align=32)
    m = db.select(jnp.zeros((1,), jnp.int32))
    args = tuple(np.array(a) for a in (m.vertices, m.normals, m.colors, m.faces, m.face_valid))
    args += (pose_z(0.4, 0.3)[None], K[None])
    j, t = render_both(args, backface_cull=True)
    assert_silhouette_only(j, t)
    _, t_nocull = render_both(args, backface_cull=False)
    np.testing.assert_array_equal(t["mask"], t_nocull["mask"])
    np.testing.assert_allclose(t["depth"], t_nocull["depth"], atol=1e-6)


def sphere_screen(rng, B, F_pad=None):
    mesh = make_uv_sphere(0.04, 12, 16)
    TCO = np.stack([pose_z(0.35 + 0.05 * b, 0.4 * b) for b in range(B)])
    TCO[:, :2, 3] = rng.normal(scale=0.01, size=(B, 2))
    args = mesh_args(mesh, TCO)
    faces, valid = args[3], args[4]
    if F_pad:
        faces = np.pad(faces, ((0, 0), (0, F_pad - faces.shape[1]), (0, 0)))
        valid = np.pad(valid, ((0, 0), (0, F_pad - valid.shape[1])))
    screen = trt.project_to_screen(*map(torch.as_tensor, (args[0], args[5], args[6])))
    return screen.numpy(), args[1], args[2], faces, valid


def test_phase_a_matches_jax(rng):
    """`prepare` against `_prepare_single`: the plane tables are equal, and
    each 16x32 tile of the port lists the active chunks of the JAX 32x128
    tile that overlap it, in the same front-to-back order; together they
    list all of the JAX tile's."""
    screen, n, c, f, fv = sphere_screen(rng, 2, F_pad=368)
    j = jax.vmap(lambda s_, n_, c_, f_, fv_: jrt._prepare_single(
        s_, n_, c_, f_, fv_, (H, W), 16, 0.01, backface_cull=True))(
        *map(jnp.asarray, (screen, n, c, f, fv)))
    t = trt.prepare(*map(torch.as_tensor, (screen, n, c, f, fv)), (H, W), 0.01,
                    backface_cull=True)
    np.testing.assert_allclose(np.asarray(j[0]), t[0].numpy(), rtol=1e-5, atol=1e-3)
    j_ids, j_n = np.asarray(j[1]), np.asarray(j[2])
    t_ids, t_n = t[1].numpy(), t[2].numpy()
    sub_h, sub_w = trt.REBASE_HW[0] // trt.TILE_H, trt.REBASE_HW[1] // trt.TILE_W
    j_tw, t_tw = W // trt.REBASE_HW[1], W // trt.TILE_W
    assert t_ids.shape[1] == j_ids.shape[1] * sub_h * sub_w
    for b in range(2):
        for jt in range(j_ids.shape[1]):
            j_list = list(j_ids[b, jt, : j_n[b, jt]])
            union = set()
            for r in range(sub_h):
                for col in range(sub_w):
                    tt = ((jt // j_tw) * sub_h + r) * t_tw + (jt % j_tw) * sub_w + col
                    t_list = list(t_ids[b, tt, : t_n[b, tt]])
                    assert t_list == [i for i in j_list if i in set(t_list)]
                    union |= set(t_list)
            assert union == set(j_list)


def test_phase_b_plain_matches_pallas_interpret(rng):
    """Each package's own phase A -> phase B, as images: the Pallas kernel
    on JAX's 32x128 tile tables against the plain phase B on the port's
    16x32 ones. Face ids agree everywhere, 1/z and attributes to f32
    rounding."""
    screen, n, c, f, fv = sphere_screen(rng, 2, F_pad=368)
    j = jax.vmap(lambda s_, n_, c_, f_, fv_: jrt._prepare_single(
        s_, n_, c_, f_, fv_, (H, W), 16, 0.01))(*map(jnp.asarray, (screen, n, c, f, fv)))
    invz_j, fid_j, attr_j = jrt._run_visibility(*j, 1, chunk=16, interpret=True)
    n_th, n_tw = 3, 1
    to_img = lambda x: np.asarray(jrt._tiles_to_image(x, n_th, n_tw, H, W, 32))
    t = trt.prepare(*map(torch.as_tensor, (screen, n, c, f, fv)), (H, W), 0.01)
    invz, fid, attr = trt.visibility_plain(*t, (H, W))
    np.testing.assert_array_equal(to_img(fid_j), fid.numpy())
    assert (fid.numpy() >= 0).any()
    np.testing.assert_allclose(to_img(invz_j), invz.numpy(), rtol=1e-6)
    attr_j = np.asarray(attr_j).reshape(2, n_th * n_tw, 6, 32, 128)
    for k in range(6):
        np.testing.assert_allclose(to_img(attr_j[:, :, k]), attr[..., k].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("F_pad", [None, 368, 1024])
def test_outputs_do_not_depend_on_batch_or_face_count(rng, F_pad):
    """A batch renders as its images one by one, and padding the face list
    with invalid faces changes nothing."""
    screen, n, c, f, fv = sphere_screen(rng, 3)
    vis = lambda *a: trt.visibility_plain(
        *trt.prepare(*map(torch.as_tensor, a), (H, W), 0.01), (H, W))
    ref = vis(screen, n, c, f, fv)
    if F_pad:
        f = np.pad(f, ((0, 0), (0, F_pad - f.shape[1]), (0, 0)))
        fv = np.pad(fv, ((0, 0), (0, F_pad - fv.shape[1])))
    whole = vis(screen, n, c, f, fv)
    for x, y in zip(whole, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    for b in range(3):
        one = vis(*(a[b : b + 1] for a in (screen, n, c, f, fv)))
        for x, y in zip(whole, one):
            np.testing.assert_array_equal(x[b : b + 1].numpy(), y.numpy())


def test_kernel_wrapper_refuses_cpu_and_bad_layouts():
    """The kernel wrapper takes CUDA tensors only: a CPU tensor is never
    silently routed to it, and mismatched layouts are refused."""
    T = (H // trt.TILE_H) * (W // trt.TILE_W)
    coefs = torch.zeros((1, 16, 32))
    ids = torch.zeros((1, T, 1), dtype=torch.int32)
    n_act = torch.zeros((1, T), dtype=torch.int32)
    with pytest.raises(ValueError):
        trt.visibility_kernel(coefs, ids, n_act, (H, W))  # CPU tensors
    with pytest.raises(ValueError):
        trt.visibility_kernel(coefs, ids[:, :12], n_act[:, :12], (H, W))  # tile count
    before = trt.visibility_kernel.launches
    trt.visibility(coefs, ids, n_act, (H, W))  # CPU: the plain twin
    assert trt.visibility_kernel.launches == before


def test_single_pass_above_the_tpu_segment_cap(monkeypatch):
    """A ~34k-face mesh at two poses. The JAX package renders it in face
    segments of at most 8192 faces (`max_faces_per_program`, merged by z);
    the port's phase B takes all faces in one pass. As in
    `tests/test_rasterizer_tiled.py::test_face_segmentation_equivalence`:
    masks exact, depth, rgb and normals within 1e-3."""
    sphere = make_uv_sphere(0.05, n_lat=116, n_lon=148)
    assert sphere.n_faces > 4 * jrt.MAX_FACES_PER_PROGRAM
    args = mesh_args(sphere, [pose_z(0.4, 0.3), pose_z(0.5, 1.1)])
    j = jrt.render_meshes_tiled(*map(jnp.asarray, args), (H, W), interpret=True, backface_cull=True,
                                max_faces_per_program=jrt.MAX_FACES_PER_PROGRAM)
    calls = []
    plain = trt.visibility_plain
    monkeypatch.setattr(trt, "visibility_plain", lambda *a: calls.append(a[0].shape) or plain(*a))
    t = trt.render_meshes_tiled(*map(torch.as_tensor, args), (H, W), backface_cull=True)
    assert len(calls) == 1 and calls[0][1] >= sphere.n_faces  # one pass over every face
    np.testing.assert_array_equal(np.asarray(j.mask), t.mask.numpy())
    assert t.mask.numpy().mean() > 0.1
    for name in ("depth", "rgb", "normals"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), atol=1e-3,
                                   err_msg=name)
