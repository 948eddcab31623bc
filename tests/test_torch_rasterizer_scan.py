"""Port vs JAX: the scan renderer (`ops/rasterizer.py render_meshes`) and
the `renderer="scan"` branches of the model and the trainer.

- The cases of `tests/test_rasterizer.py` (cube silhouette and depth,
  normals and colour, translation, sphere depth profile, a non-finite
  pose, behind the camera, `face_valid`, occlusion order, 240x320) and a
  textured synthdemo model at its ground-truth pose, each through both
  packages' `render_meshes` on the same inputs: the same winning face at
  every pixel except where the pixel centre lies on an edge of one of the
  two faces to within rounding (an edge function within 1e-3 px^2 of 0
  in float64; XLA on the CPU fuses the edge function's multiply-subtract
  into one rounding where torch rounds twice: on the cube, 14 pixels of
  its front face's diagonal, where JAX leaves a crack that shows the back
  face; at most 1% of the covered pixels), and elsewhere depth, rgb and
  normals within 1e-5. Each case also keeps its JAX test's own
  assertion.
- The output does not depend on how the images are grouped (bit for bit).
- `score_views` and `refine_step` of models with `renderer="scan"` against
  the JAX models with the same weights (logits within 1e-4, poses within
  1e-5), and `synthetic_batch_fn(renderer="scan")` against the JAX
  package's from the same draws (rgb within 1e-5, boxes within 1e-4 px).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.meshes import make_cube, make_uv_sphere
from megapose6d_tpu.ops import rasterizer as jr
from megapose6d_tpu_torch.ops import rasterizer as tr
from megapose6d_tpu_torch.ops._precision import pin_f32
from tests.test_torch_textures import synthdemo_dbs

pin_f32()
H, W = 120, 160
K = np.asarray([[300.0, 0, W / 2 - 0.5], [0, 300.0, H / 2 - 0.5], [0, 0, 1]], np.float32)
K2 = np.asarray([[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]], np.float32)
SCENE = Path(__file__).resolve().parents[1] / "runs/ar_dr/synthdemo"
ATOL = 1e-5


def pose_z(z, x=0.0):
    T = np.eye(4, dtype=np.float32)
    T[2, 3], T[0, 3] = z, x
    return T


def mesh_inputs(mesh, TCO, K_=K, valid=True):
    n = mesh.n_faces
    return dict(vertices=mesh.vertices[None], normals=mesh.vertex_normals[None], colors=mesh.vertex_colors[None],
                faces=mesh.faces[None].astype(np.int32), face_valid=np.full((1, n), valid),
                TCO=np.asarray(TCO, np.float32)[None], K=np.asarray(K_, np.float32)[None])


def occlusion_inputs():
    near, far = make_cube(0.02), make_cube(0.08)
    verts = np.concatenate([near.vertices, far.vertices + [0, 0, 0.2]]).astype(np.float32)
    faces = np.concatenate([near.faces, far.faces + near.n_vertices]).astype(np.int32)
    colors = np.concatenate([np.tile([1.0, 0, 0], (near.n_vertices, 1)),
                             np.tile([0, 1.0, 0], (far.n_vertices, 1))]).astype(np.float32)
    return dict(vertices=verts[None], normals=np.concatenate([near.vertex_normals, far.vertex_normals])[None],
                colors=colors[None], faces=faces[None], face_valid=np.ones((1, len(faces)), bool),
                TCO=pose_z(0.5)[None], K=K[None])


def textured_inputs():
    """Both synthdemo models at their ground-truth poses in frame 0 of scene
    000000 (240x320), textured."""
    j, t = synthdemo_dbs()
    gt = json.loads((SCENE / "test/000000/scene_gt.json").read_text())["0"]
    cam = json.loads((SCENE / "test/000000/scene_camera.json").read_text())["0"]
    idx = [t.labels.index(f"obj_{o['obj_id']:06d}") for o in gt]
    TCO = np.stack([np.block([[np.reshape(o["cam_R_m2c"], (3, 3)), np.asarray(o["cam_t_m2c"])[:, None] / 1000.0],
                              [np.zeros((1, 3)), np.ones((1, 1))]]) for o in gt]).astype(np.float32)
    m = t.select(torch.as_tensor(idx))
    d = dict(vertices=m.vertices, normals=m.normals, colors=m.colors, faces=m.faces, face_valid=m.face_valid,
             TCO=TCO, K=np.tile(np.reshape(cam["cam_K"], (1, 3, 3)), (len(idx), 1, 1)).astype(np.float32),
             uvs=m.uvs, textures=m.textures, has_tex=m.has_tex)
    return {k: np.asarray(v) for k, v in d.items()}


def check_cube(o):
    half_px = 300 * 0.05 / 0.45
    assert abs(o["mask"][0].sum() - (2 * half_px) ** 2) / (2 * half_px) ** 2 < 0.05
    np.testing.assert_allclose(o["depth"][0, H // 2, W // 2], 0.45, atol=1e-3)
    ys, xs = np.nonzero(o["mask"][0])
    np.testing.assert_allclose([xs.mean(), ys.mean()], [W / 2 - 0.5, H / 2 - 0.5], atol=1.0)


def check_colour(o):
    np.testing.assert_allclose(o["normals"][0, H // 2, W // 2], [0.5, 0.5, 0.0], atol=0.05)
    np.testing.assert_allclose(o["rgb"][0, H // 2, W // 2], [0.4, 0.1, 0.1], atol=0.03)


def check_translation(o):
    xs = np.nonzero(o["mask"][0])[1]
    np.testing.assert_allclose(xs.mean(), W / 2 - 0.5 + 300 * 0.05 / 0.45, atol=3.0)


def check_sphere(o):
    np.testing.assert_allclose(o["depth"][0, H // 2, W // 2], 0.36, atol=2e-3)
    r_px = 300 * 0.04 / np.sqrt(0.4**2 - 0.04**2)
    np.testing.assert_allclose(o["mask"][0].sum(), np.pi * r_px**2, rtol=0.05)


def check_empty(o):
    assert not o["mask"].any() and (o["rgb"] == 0).all() and (o["depth"] == 0).all()


def check_occlusion(o):
    cy, cx = H // 2, W // 2
    np.testing.assert_allclose(o["depth"][0, cy, cx], 0.48, atol=1e-3)
    assert o["rgb"][0, cy, cx, 0] > o["rgb"][0, cy, cx, 1]
    off = int(300 * 0.06 / 0.7) + 6
    assert o["mask"][0, cy, cx + off]
    np.testing.assert_allclose(o["depth"][0, cy, cx + off], 0.62, atol=2e-3)


def check_240x320(o):
    assert o["rgb"].shape == (1, 240, 320, 3) and o["mask"].sum() > 100


def check_textured(o):
    assert o["mask"].sum() > 1000 and o["rgb"][o["mask"]].std() > 0.05


def nan_pose():
    T = pose_z(0.5)
    T[0, 3] = np.nan
    return T


CASES = {
    "cube_silhouette_depth": (lambda: mesh_inputs(make_cube(0.05), pose_z(0.5)), (H, W), check_cube),
    "cube_normals_colour": (lambda: mesh_inputs(make_cube(0.05, color=(0.8, 0.2, 0.2)), pose_z(0.5)), (H, W),
                            check_colour),
    "translation": (lambda: mesh_inputs(make_cube(0.05), pose_z(0.5, x=0.05)), (H, W), check_translation),
    "sphere_depth_profile": (lambda: mesh_inputs(make_uv_sphere(0.04, 24, 32), pose_z(0.4)), (H, W),
                             check_sphere),
    "nonfinite_pose": (lambda: mesh_inputs(make_cube(0.05), nan_pose()), (H, W), check_empty),
    "behind_camera": (lambda: mesh_inputs(make_cube(0.05), pose_z(-0.5)), (H, W), check_empty),
    "face_valid": (lambda: mesh_inputs(make_cube(0.05), pose_z(0.5), valid=False), (H, W), check_empty),
    "occlusion_order": (occlusion_inputs, (H, W), check_occlusion),
    "240x320": (lambda: mesh_inputs(make_cube(0.05), pose_z(0.6), K_=K2), (240, 320), check_240x320),
    "textured_synthdemo": (textured_inputs, (240, 320), check_textured),
}


def render_both(inputs, hw, **kw):
    names = ("vertices", "normals", "colors", "faces", "face_valid", "TCO", "K")
    tex = {k: inputs[k] for k in ("uvs", "textures", "has_tex") if k in inputs}
    jo = jr.render_meshes(*(jnp.asarray(inputs[k]) for k in names), hw,
                          **{k: jnp.asarray(v) for k, v in tex.items()}, **kw)
    to = tr.render_meshes(*(torch.as_tensor(inputs[k]) for k in names), hw,
                          **{k: torch.as_tensor(v) for k, v in tex.items()}, **kw)
    return ({k: np.asarray(v) for k, v in jo._asdict().items()}, {k: v.numpy() for k, v in to._asdict().items()})


def face_ids_both(inputs, hw, chunk=64):
    """Pass 1's face ids `[B, H*W]` in both packages, and the screen
    coordinates in float64."""
    TCO, finite = np.asarray(inputs["TCO"]), np.isfinite(inputs["TCO"]).all(axis=(1, 2))
    TCO = np.where(finite[:, None, None], TCO, np.eye(4, dtype=np.float32))
    screen = np.asarray(jr.project_to_screen(jnp.asarray(inputs["vertices"]), jnp.asarray(TCO),
                                             jnp.asarray(inputs["K"])))
    valid = inputs["face_valid"] & finite[:, None]
    fj = jax.vmap(lambda s, f, v: jr._visibility_single(s, f, v, hw, chunk, 0.01)[0])(
        jnp.asarray(screen), jnp.asarray(inputs["faces"]), jnp.asarray(valid))
    ft = tr._visibility(torch.as_tensor(screen), torch.as_tensor(inputs["faces"]), torch.as_tensor(valid), hw,
                        chunk, 0.01)
    return np.asarray(fj), ft.numpy(), screen.astype(np.float64)


def on_an_edge(screen, faces, f, pix, W_, tol=1e-3) -> bool:
    """Whether pixel `pix` lies on an edge of face `f` (an edge function,
    in float64, within `tol` px^2 of 0) while inside or on it."""
    if f < 0:
        return False
    (u0, v0, _), (u1, v1, _), (u2, v2, _) = screen[faces[f]]
    pu, pv = pix % W_, pix // W_
    e = [(bx - ax) * (pv - ay) - (by - ay) * (pu - ax)
         for ax, ay, bx, by in ((u1, v1, u2, v2), (u2, v2, u0, v0), (u0, v0, u1, v1))]
    s = np.sign(sum(e))
    return min(abs(x) for x in e) <= tol and all(s * x >= -tol for x in e)


@pytest.mark.parametrize("case", list(CASES))
def test_render_matches_jax(case):
    make, hw, check = CASES[case]
    inputs = make()
    jo, to = render_both(inputs, hw)
    fj, ft, screen = face_ids_both(inputs, hw)
    np.testing.assert_array_equal(ft.reshape(to["mask"].shape) >= 0, to["mask"])
    np.testing.assert_array_equal(fj.reshape(jo["mask"].shape) >= 0, jo["mask"])
    # Where the winning faces differ, the pixel centre lies on an edge of one
    # of them to within rounding: XLA fuses the edge function's
    # multiply-subtract into one rounding, torch rounds twice.
    for b, pix in zip(*np.nonzero(fj != ft)):
        assert any(on_an_edge(screen[b], inputs["faces"][b], f, pix, hw[1]) for f in (fj[b, pix], ft[b, pix])), \
            (b, pix, fj[b, pix], ft[b, pix])
    same = (fj == ft).reshape(to["mask"].shape)
    assert (~same).sum() <= max(16, 0.01 * to["mask"].sum()), (~same).sum()
    for k in ("depth", "rgb", "normals"):
        np.testing.assert_allclose(to[k][same], jo[k][same], atol=ATOL, rtol=0, err_msg=k)
    check(to)
    check(jo)


def test_grouping_changes_nothing():
    """Four poses of the sphere and the NaN pose, in groups of 1, 2 and
    all at once, with a face chunk that pads the last chunk."""
    sph = make_uv_sphere(0.04, 12, 16)
    TCO = np.stack([pose_z(0.3 + 0.05 * i, x=0.01 * i) for i in range(4)] + [nan_pose()])
    d = mesh_inputs(sph, TCO[0])
    args = [torch.as_tensor(np.repeat(d[k], 5, axis=0)) for k in ("vertices", "normals", "colors", "faces",
                                                                    "face_valid")]
    outs = [tr.render_meshes(*args, torch.as_tensor(TCO), torch.as_tensor(K).expand(5, 3, 3), (H, W), chunk=40,
                             group=g) for g in (1, 2, None)]
    assert outs[0].mask[:4].any(dim=(1, 2)).all() and not outs[0].mask[4].any()
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert torch.equal(a, b)


@pytest.mark.parametrize("step", ["score_views", "refine_step"])
def test_model_scan_branch_matches_jax(rng, step):
    """`renderer="scan"` in both packages' models, same weights, f32, the
    CPU tests' small size: renders within 1e-4, logits and pose outputs
    within 1e-4, poses within 1e-5."""
    from megapose6d_tpu.models import pose_predictor as jpp
    from megapose6d_tpu_torch.models import pose_predictor as tpp
    from tests.test_torch_pose_predictor import close, init_both, japply, scene

    if step == "score_views":
        kw, makers, labels = dict(renderer="scan", face_chunk=48), (jpp.make_coarse_config,
                                                                    tpp.make_coarse_config), ["cube", "sphere", "cube"]
    else:
        kw = dict(renderer="scan", face_chunk=48, n_rendered_views=2, multiview_type="TCO+front_1view")
        makers, labels = (jpp.make_refiner_config, tpp.make_refiner_config), ["sphere", "cube"]
    jm, params, tm, jdb, tdb_ = init_both(kw, *makers, 2)
    assert tm.cfg.renderer == "scan" and tm.cfg.face_chunk == 48
    img, K, TCO = scene(rng, len(labels))
    method = getattr(jpp.PosePredictor, step)
    jout = japply(jm, params, method, jnp.asarray(img), jnp.asarray(K), jnp.asarray(TCO),
                  jdb.select(jdb.label_to_index(labels)))
    with torch.no_grad():
        tout = getattr(tm, step)(torch.as_tensor(img), torch.as_tensor(K), torch.as_tensor(TCO),
                                 tdb_.select(tdb_.label_to_index(labels)))
    close(jout["renders"], tout["renders"], 1e-4)
    assert (tout["renders"] > 0).any()
    if step == "score_views":
        close(jout["logits"], tout["logits"], 1e-4)
    else:
        close(jout["network_outputs"]["pose"], tout["network_outputs"]["pose"], 1e-4)
        close(jout["TCO_output"], tout["TCO_output"], 1e-5)
    tiled = tm.twin(renderer="tiled")
    with torch.no_grad():
        other = getattr(tiled, step)(torch.as_tensor(img), torch.as_tensor(K), torch.as_tensor(TCO),
                                     tdb_.select(tdb_.label_to_index(labels)))
    assert not torch.equal(other["renders"], tout["renders"])  # the config picks the renderer


def test_synthetic_batch_scan_matches_jax():
    from megapose6d_tpu.training.train import synthetic_batch_fn as j_synthetic_batch_fn
    from megapose6d_tpu_torch.training import train as tt
    from tests.torch_training_refs import INPUT, j_db, jax_synthetic_draws, t_db

    jdb, tdb_ = j_db(), t_db()
    B, key = 3, jax.random.PRNGKey(21)
    jb = jax.jit(j_synthetic_batch_fn(jdb, B, INPUT, f=120.0, face_chunk=32, renderer="scan"))(key)
    synth = tt.synthetic_batch_fn(tdb_, B, INPUT, f=120.0, device="cpu", face_chunk=32, renderer="scan")
    tb = synth.make(jax_synthetic_draws(key, B, len(tdb_.labels)))
    for name in ("TCO", "K", "bboxes"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), atol=1e-4)
    np.testing.assert_allclose(tb.rgbs.numpy(), np.asarray(jb.rgbs), atol=1e-5, rtol=0)
    assert np.asarray(jb.rgbs).max() > 0.1
    assert tt.synthetic_batch_fn(tdb_, B, INPUT, device="cpu").renderer == "tiled"  # None: tiled everywhere
