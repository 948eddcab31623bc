"""Port vs JAX: per-pixel textures (mirrors `tests/test_textures.py`).

The same meshes go through both packages' readers, mesh databases and
tiled renderers (the JAX renderer with the Pallas kernel interpreted, the
port's with `visibility_plain`). Readers, texture resizing and the mesh
databases must agree exactly: both do the same numpy work, and
`_resize_texture` reimplements PIL's bilinear resize in fixed point.
Renders: identical masks; rgb on covered pixels within 5e-4, and within
1e-4 on at least 99.9% of them. The texture lookup multiplies a uv
difference by the texture size (256) and the texel gradient (up to 1 per
texel), so the last-bit differences of XLA's and torch's phase-A
arithmetic (1/z off by ~2e-7 at a few pixels) reach ~2e-4 in rgb on the
committed models; on the checker quad the renders agree within 1e-4.

Textures in every format the JAX package opens through PIL's
`convert("RGB")`: each PNG layout of `tests/data/torch_images/png`
(palettes, tRNS, 1/2/4-bit grey, grey with alpha, Adam7), the synthdemo
textures as Adam7, tRNS, RGBA, palette and JPEG files, a grey TIFF and
16-bit grey (clipped to 255), read by `load_ply` and `load_obj` (baked and
not) with the native decoder built and forced off: texture arrays and baked
colours bit for bit the JAX package's. Palette and grey-with-alpha
backgrounds through `ReplaceBackgroundTransform` likewise.
"""

from pathlib import Path

import json
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from megapose6d_tpu.data import augmentations as ja
from megapose6d_tpu.meshes import io as jio
from megapose6d_tpu.meshes import mesh_db as jdb
from megapose6d_tpu.ops import rasterizer_tiled as jrt
from megapose6d_tpu_torch import native
from megapose6d_tpu_torch.data import augmentations as ta
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.meshes import mesh_db as tdb
from megapose6d_tpu_torch.ops import rasterizer_tiled as trt
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.utils.png import encode_png
from tests.test_textures import _expected_checker, make_checker, make_textured_quad
from tests.test_torch_augmentations import _apply, _obs_pair, _same
from tests.torch_image_fixtures import OUT

pin_f32()
SCENE = Path(__file__).resolve().parents[1] / "runs/ar_dr/synthdemo"
MESH_FIELDS = ("vertices", "faces", "vertex_normals", "vertex_colors", "vertex_uvs", "texture")
DB_FIELDS = ("vertices", "normals", "colors", "faces", "face_valid", "points", "symmetries",
             "sym_valid", "diameters", "uvs", "textures", "has_tex")


def assert_same_mesh(a, b):
    for k in MESH_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def assert_same_db(j, t):
    assert tuple(j.labels) == tuple(t.labels)
    for k in DB_FIELDS:
        a, b = getattr(j, k), getattr(t, k)
        assert (a is None) == (b is None), k
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def port_mesh(m):
    return tio.TriMesh(m.vertices, m.faces, vertex_normals=m.vertex_normals,
                       vertex_colors=m.vertex_colors, vertex_uvs=m.vertex_uvs, texture=m.texture)


def quad_dbs(texture_size=128, plain=False):
    """The checker quad (and an untextured copy) in both mesh databases."""
    jq = make_textured_quad()

    def objects(db, mesh):
        objs = [db.RigidObject(label="quad", mesh=mesh)]
        if plain:
            objs.append(db.RigidObject(label="plain", mesh=type(mesh)(
                mesh.vertices, mesh.faces, vertex_colors=np.full((4, 3), 0.25, np.float32))))
        return db.RigidObjectDataset(objs)

    kw = dict(max_faces=128, n_points=16, n_sym=2, texture_size=texture_size)
    j = jdb.MeshDataBase.from_object_ds(objects(jdb, jq), **kw).batched(align=8)
    t = tdb.MeshDataBase.from_object_ds(objects(tdb, port_mesh(jq)), **kw).batched(align=8, device="cpu")
    return j, t


def render_both(j, t, idx, TCO, K, hw, **kw):
    jm, tm = j.select(jnp.asarray(idx)), t.select(torch.as_tensor(idx))
    jo = jrt.render_meshes_tiled(
        jm.vertices, jm.normals, jm.colors, jm.faces, jm.face_valid, jnp.asarray(TCO), jnp.asarray(K),
        hw, interpret=True, uvs=jm.uvs, textures=jm.textures, has_tex=jm.has_tex, **kw)
    to = trt.render_meshes_tiled(
        tm.vertices, tm.normals, tm.colors, tm.faces, tm.face_valid, torch.as_tensor(TCO),
        torch.as_tensor(K), hw, **tm.texture_kw, **kw)
    return ({k: np.asarray(v) for k, v in jo._asdict().items()},
            {k: v.numpy() for k, v in to._asdict().items()})


def test_textured_quad_tiled_matches_jax():
    j, t = quad_dbs()
    TCO = np.eye(4, dtype=np.float32)[None]
    TCO[0, 2, 3] = 1.0
    K = np.asarray([[[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]]], np.float32)
    jo, to = render_both(j, t, [0], TCO, K, (64, 64), light_ambient=1.0, light_point=0.0)
    _expected_checker(to["rgb"], to["mask"])  # the checker, cell by cell
    np.testing.assert_array_equal(jo["mask"], to["mask"])
    hit = to["mask"]
    np.testing.assert_allclose(jo["rgb"][hit], to["rgb"][hit], atol=1e-4)
    np.testing.assert_allclose(jo["depth"], to["depth"], atol=1e-5)


def test_textured_differs_from_untextured():
    """Same silhouette, a different interior: the texture is sampled."""
    _, t = quad_dbs()
    m = t.select(torch.zeros(1, dtype=torch.long))
    TCO = torch.eye(4)[None].clone()
    TCO[0, 2, 3] = 1.0
    K = torch.tensor([[[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]]])
    args = (m.vertices, m.normals, m.colors, m.faces, m.face_valid, TCO, K, (64, 64))
    tex = trt.render_meshes_tiled(*args, light_ambient=1.0, light_point=0.0, **m.texture_kw)
    flat = trt.render_meshes_tiled(*args, light_ambient=1.0, light_point=0.0)
    assert torch.equal(tex.mask, flat.mask)
    assert (tex.rgb - flat.rgb).abs().max() > 0.3


def test_mesh_db_select_carries_textures():
    j, t = quad_dbs(texture_size=64, plain=True)
    assert_same_db(j, t)
    assert tuple(t.textures.shape[1:]) == (64, 64, 3)
    assert t.has_tex.tolist() == [True, False]
    idx = [1, 0, 0]
    sel = t.select(torch.as_tensor(idx))
    assert sel.has_tex.tolist() == [False, True, True]
    assert_same_db(j.select(jnp.asarray(idx)), sel)
    rep = sel.repeat_interleave(2)
    assert rep.has_tex.tolist() == [False, False, True, True, True, True]
    assert set(rep.texture_kw) == {"uvs", "textures", "has_tex"}


def test_untextured_db_has_no_texture_fields():
    objs = tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04))])
    db = tdb.MeshDataBase.from_object_ds(objs, max_faces=64, n_points=8, n_sym=2).batched(
        align=16, device="cpu")
    assert db.textures is None and db.uvs is None and db.has_tex is None
    assert db.select(torch.zeros(2, dtype=torch.long)).texture_kw == {}


def test_ply_texture_read_matches_jax(tmp_path):
    """A textured cube written by the JAX package's PLY writer (uv, and
    the texture as a PNG beside it), and the committed BOP models."""
    path = jio.save_ply(jio.make_cube(0.05, textured=True, seed=3), tmp_path / "obj_000007.ply")
    a, b = jio.load_ply(path), tio.load_ply(path)
    assert b.texture is not None and b.vertex_uvs.shape == (24, 2)
    assert_same_mesh(a, b)
    for p in sorted((SCENE / "models").glob("*.ply")):
        a, b = jio.load_ply(p), tio.load_ply(p)
        assert b.texture is not None and b.texture.shape == (192, 192, 3)
        assert_same_mesh(a, b)


@pytest.mark.parametrize("bake", [True, False])
def test_obj_texture_read_matches_jax(tmp_path, bake):
    """An OBJ with per-corner vt and a material texture (an RGBA PNG, so
    the alpha channel is dropped as PIL's convert("RGB") drops it)."""
    tex = np.concatenate([make_checker(2, 4), np.full((8, 8, 1), 200, np.uint8)], -1)
    Image.fromarray(tex).save(tmp_path / "t.png")
    (tmp_path / "m.mtl").write_text("newmtl m\nmap_Kd t.png\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1.5\n"
        "f 1/1 2/2 3/3\nf 1/1 3/3 -1/-1\n"
    )
    a = jio.load_obj(tmp_path / "q.obj", bake_texture=bake)
    b = tio.load_mesh(tmp_path / "q.obj", bake_texture=bake)
    assert (b.texture is None) == bake and (b.vertex_colors is None) != bake
    assert_same_mesh(a, b)


def test_bake_texture_to_colors_matches_jax():
    jq = make_textured_quad()
    a, b = jio.bake_texture_to_colors(jq), tio.bake_texture_to_colors(port_mesh(jq))
    assert b.texture is None and b.vertex_uvs is None
    assert_same_mesh(a, b)


@pytest.mark.parametrize("case", ["obj_000001", "obj_000002", "down_512", "odd_300x200", "up_7x9"])
def test_resize_texture_matches_pil(case):
    """Bit for bit PIL's bilinear resize: the committed textures (192 ->
    256, the upsampling branch), a downsample and odd shapes."""
    rng = np.random.RandomState(0)
    if case.startswith("obj"):
        tex = np.asarray(Image.open(SCENE / "models" / f"{case}.png").convert("RGB"))
    else:
        shape = {"down_512": (512, 512), "odd_300x200": (300, 200), "up_7x9": (7, 9)}[case]
        tex = rng.randint(0, 256, size=shape + (3,)).astype(np.uint8)
    expected = np.asarray(Image.fromarray(tex).resize((256, 256), Image.BILINEAR))
    got = tdb._resize_texture(tex, 256)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, expected)


def synthdemo_dbs():
    def objects(db):
        return db.RigidObjectDataset([db.RigidObject(label=p.stem, mesh_path=p, mesh_units="mm")
                                      for p in sorted((SCENE / "models").glob("*.ply"))])
    return (jdb.MeshDataBase.from_object_ds(objects(jdb)).batched(),
            tdb.MeshDataBase.from_object_ds(objects(tdb)).batched(device="cpu"))


def test_synthdemo_db_matches_jax_with_textures():
    j, t = synthdemo_dbs()
    assert t.has_tex.tolist() == [True, True]
    assert tuple(t.textures.shape) == (2, 256, 256, 3)
    assert_same_db(j, t)


def test_synthdemo_textured_render_matches_jax():
    """Both models at their ground-truth poses in the first two frames of
    scene 000000, 240x320, as the normals configs render them (ambient
    1.0, backface cull). The port without textures was 0.29-0.34 away in
    mean |rgb| (fault F1)."""
    j, t = synthdemo_dbs()
    gt = json.loads((SCENE / "test/000000/scene_gt.json").read_text())
    cam = json.loads((SCENE / "test/000000/scene_camera.json").read_text())
    idx, TCO, K = [], [], []
    for im in ("0", "1"):
        for o in gt[im]:
            idx.append(t.labels.index(f"obj_{o['obj_id']:06d}"))
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = np.reshape(o["cam_R_m2c"], (3, 3))
            T[:3, 3] = np.asarray(o["cam_t_m2c"]) / 1000.0
            TCO.append(T)
            K.append(np.reshape(cam[im]["cam_K"], (3, 3)))
    TCO, K = np.stack(TCO).astype(np.float32), np.stack(K).astype(np.float32)
    jo, to = render_both(j, t, idx, TCO, K, (240, 320), light_ambient=1.0, light_point=0.0,
                         backface_cull=True)
    np.testing.assert_array_equal(jo["mask"], to["mask"])
    hit = to["mask"]
    assert hit.sum() > 1000
    err = np.abs(jo["rgb"] - to["rgb"])[hit].max(-1)
    assert err.max() <= 5e-4, err.max()
    assert (err <= 1e-4).mean() >= 0.999, (err <= 1e-4).mean()
    np.testing.assert_allclose(jo["depth"][hit], to["depth"][hit], rtol=1e-6)


# Every texture format: the committed PNG layouts and texture copies, a
# grey TIFF, 16-bit grey as TIFF and as PNG (written here, with values
# above 255).
TEXTURES = sorted(str(p.relative_to(OUT)) for d in ("png", "textures") for p in (OUT / d).iterdir()) + [
    "tiff/grey8.tif", "tiff/grey16_deflate.tif", "grey16.png"]


def _texture_file(tmp_path, rel):
    dst = tmp_path / Path(rel).name
    if rel == "grey16.png":
        ramp = np.arange(24 * 32, dtype=np.uint16).reshape(24, 32) * 83
        dst.write_bytes(encode_png(ramp))
    else:
        shutil.copy(OUT / rel, dst)
    return dst.name


@pytest.mark.parametrize("route", ["default", "png.py"])
@pytest.mark.parametrize("rel", TEXTURES)
def test_ply_texture_formats_match_jax(tmp_path, monkeypatch, rel, route):
    """The committed synthdemo PLY, its `comment TextureFile` pointed at a
    texture of each format."""
    name = _texture_file(tmp_path, rel)
    ply = (SCENE / "models/obj_000001.ply").read_text()
    assert "comment TextureFile obj_000001.png\n" in ply
    (tmp_path / "m.ply").write_text(ply.replace("TextureFile obj_000001.png", f"TextureFile {name}"))
    if route == "png.py":
        monkeypatch.setitem(native._libs, "decode", None)
    a, b = jio.load_ply(tmp_path / "m.ply"), tio.load_ply(tmp_path / "m.ply")
    assert b.texture is not None and b.texture.shape[2] == 3
    assert_same_mesh(a, b)


@pytest.mark.parametrize("bake", [True, False])
@pytest.mark.parametrize("rel", TEXTURES)
def test_obj_texture_formats_match_jax(tmp_path, rel, bake):
    name = _texture_file(tmp_path, rel)
    (tmp_path / "m.mtl").write_text(f"newmtl m\nmap_Kd {name}\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0.1 0.2\nvt 0.9 0.15\nvt 0.7 0.8\nvt 0.05 0.95\n"
        "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n"
    )
    a = jio.load_obj(tmp_path / "q.obj", bake_texture=bake)
    b = tio.load_mesh(tmp_path / "q.obj", bake_texture=bake)
    assert (b.texture is None) == bake and (b.vertex_colors is None) != bake
    assert_same_mesh(a, b)


@pytest.mark.parametrize("route", ["default", "png.py"])
def test_palette_and_grey_alpha_backgrounds_match_jax(monkeypatch, route):
    paths = [OUT / "png" / n for n in ("palette8_48x64.png", "palette4_32x40.png", "palette8_trns_40x48.png",
                                       "adam7_palette2_trns_29x43.png", "grey_alpha_48x64.png",
                                       "grey1_trns_64x64.png")]
    if route == "png.py":
        monkeypatch.setitem(native._libs, "decode", None)
    seen = set()
    for seed in range(12):
        jo, to = _obs_pair(seed)
        random.seed(seed)
        seen.add(random.choice(paths))
        _same(_apply(ja.ReplaceBackgroundTransform(paths), jo, seed),
              _apply(ta.ReplaceBackgroundTransform(paths), to, seed))
    assert len(seen) >= 4
