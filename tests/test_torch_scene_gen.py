"""Port vs JAX: the synthetic scene generator and what it writes.

`fold_in` bit for bit; the PNG encoder read back by the port's decoder and
by PIL; `SceneRenderer` (the JAX package's `make_scene_renderer`) at 64x96 with 3 of `_default_objects` in
every observation domain; `generate`'s webdataset shards and
`generate_bop`'s BOP tree, read back by both packages' readers; and the
first frames of `demo_ar_baseline`'s dataset at its full 240x320.

The mesh databases keep every face (`max_faces=2048`): decimation is the
JAX package's native library in another face order (ROADMAP Queue 3),
which moves pixels where two faces tie.

Tolerances. A scene's draws are bit for bit, so the segmentation, the
visible fractions, the labels and the boxes are equal, and the poses
within 1e-6 (the two packages' quaternion-to-matrix rounding). Depth
within 1 mm (the BOP depth's step; measured at most 1.04e-4 m, on a pixel
on the edge between two faces of one object, which phase A's last-bit
differences give to either face). rgb: float32 shading in another order moves a value by a
few ulps (up to 3e-3 where a texel edge amplifies a last-bit uv
difference), so the 8-bit truncation flips a level; and where the lit
share of a pixel sits at its threshold (`zl <= d_map + bias`), a flip
moves the pixel by tens of levels. So at most 1 in 5000 pixels may be
off by more than one level, by any amount. Measured: at 64x96 0.5-1.5%
of the pixels off by one level, none by more; over the 56 frames of the
240x320 demo set 4.9e-6 of the pixels off by more than one level (at
most 3.9e-5 of a frame, up to 175 levels), which moves with the CPU's
thread count (a float32 mean in another order); the same holds for the
committed frames 0 and 1, whose visible fractions differ by up to 6e-8
(the TPU's division).
"""

import io
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from megapose6d_tpu.data.bop_scene_dataset import BOPDataset as JBOPDataset
from megapose6d_tpu.data.web_scene_dataset import WebSceneDataset as JWebSceneDataset
from megapose6d_tpu.meshes.mesh_db import MeshDataBase as JMeshDataBase
from megapose6d_tpu.scripts import demo_ar_baseline as jdemo
from megapose6d_tpu.scripts import generate_synthetic_dataset as jgen
from megapose6d_tpu_torch.data.bop_scene_dataset import BOPDataset
from megapose6d_tpu_torch.data.web_scene_dataset import IterableWebSceneDataset, WebSceneDataset
from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.scripts import demo_ar_baseline as demo
from megapose6d_tpu_torch.scripts import generate_synthetic_dataset as gen
from megapose6d_tpu_torch.utils import threefry
from megapose6d_tpu_torch.utils.png import decode_png, encode_png, read_png

pin_f32()
ROOT = Path(__file__).resolve().parents[1]
RES = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops gain nothing from threads and slow down many times
    over when the test workers' thread pools contend for the cores; one
    thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dbs():
    jdb = JMeshDataBase.from_object_ds(jgen._default_objects(), max_faces=2048, n_points=128, n_sym=2).batched(align=32)
    tdb = MeshDataBase.from_object_ds(gen._default_objects(), max_faces=2048, n_points=128, n_sym=2).batched(
        align=32, device="cpu")
    return jdb, tdb


def rgb8(x) -> np.ndarray:
    return (np.clip(np.asarray(x) * 255, 0, 255)).astype(np.uint8).astype(int)


def assert_rgb_close(a: np.ndarray, b: np.ndarray) -> None:
    """8-bit images: at most 1 in 5000 pixels off by more than one level."""
    off = (np.abs(a.astype(int) - b.astype(int)) > 1).any(-1)
    assert off.mean() <= 2e-4, (off.sum(), off.size)


def test_fold_in_bit_for_bit():
    for seed in (0, 7, 2**32 - 1):
        key = jax.random.PRNGKey(seed)
        for data in (0, 1, 12345, 2**31 + 3, 2**32 - 1):
            np.testing.assert_array_equal(threefry.fold_in(np.asarray(key), data),
                                          np.asarray(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_png_round_trip(kind, tmp_path):
    rng = np.random.RandomState(0)
    img = {"rgb8": rng.randint(0, 256, (37, 53, 3)), "gray8": rng.randint(0, 256, (20, 31)),
           "gray16": rng.randint(0, 65536, (19, 23))}[kind].astype(np.uint16 if kind == "gray16" else np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert pil.dtype == img.dtype
    np.testing.assert_array_equal(pil, img)


def assert_scene_close(j, t, i=0):
    rgb, depth, seg, TCO, mesh_idx, K, visib = map(np.asarray, j)
    np.testing.assert_array_equal(t["seg"][i].numpy(), seg)
    np.testing.assert_array_equal(t["mesh_idx"][i].numpy(), mesh_idx)
    np.testing.assert_array_equal(t["visib"][i].numpy(), visib)
    np.testing.assert_allclose(t["TCO"][i].numpy(), TCO, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t["K"].numpy(), K)
    np.testing.assert_allclose(t["depth"][i].numpy(), depth, atol=1e-3, rtol=0)
    assert_rgb_close(rgb8(t["rgb"][i].numpy()), rgb8(rgb))


@pytest.mark.parametrize("domain", [dict(), dict(shadows=False), dict(ibl=False),
                                    dict(unlit=True, background=False)], ids=["realism", "no_shadows", "no_ibl", "unlit"])
def test_scene_renderer_matches_jax(dbs, domain):
    jdb, tdb = dbs
    jr = jgen.make_scene_renderer(jdb, 3, RES, 120.0, **domain)
    tr = gen.SceneRenderer(tdb, 3, RES, 120.0, **domain)
    keys = [jax.random.PRNGKey(s) for s in (0, 3)]
    out = tr(np.stack([np.asarray(k) for k in keys]))  # both scenes in one batch
    for i, key in enumerate(keys):
        assert_scene_close(jr(key), out, i)
    assert (out["seg"] > 0).any() and out["visib"].max() > 0
    light = jax.random.PRNGKey(50)  # a separate key for the light's draws
    assert_scene_close(jr(keys[0], light), tr(np.asarray(keys[0]), np.asarray(light)))


def frames_equal(a, b, visib_atol=0.0):
    """Two decoded frames of the two generators (see the tolerances)."""
    np.testing.assert_array_equal(a.segmentation, b.segmentation)
    assert_rgb_close(a.rgb, b.rgb)
    if a.depth is not None:
        assert np.abs(a.depth - b.depth).max() <= 1.001e-3
    assert [o.label for o in a.object_datas] == [o.label for o in b.object_datas]
    for oa, ob in zip(a.object_datas, b.object_datas):
        np.testing.assert_allclose(oa.TWO, ob.TWO, atol=2e-6)
        assert oa.unique_id == ob.unique_id and abs(oa.visib_fract - ob.visib_fract) <= visib_atol
        if oa.bbox_modal is not None:
            np.testing.assert_array_equal(oa.bbox_modal, ob.bbox_modal)


def test_generate_shards_match_jax(dbs, tmp_path):
    jdb, tdb = dbs
    kw = dict(n_frames=5, resolution=(64, 128), n_obj_per_scene=2, f=120.0, frames_per_shard=3)
    shards = gen.generate(tdb, tmp_path / "port", **kw)
    jgen.generate(jdb, tmp_path / "jax", **kw)
    assert [p.name for p in shards] == ["shard-000000.tar", "shard-000001.tar"]
    port, port_by_jax = WebSceneDataset(tmp_path / "port", load_depth=True), JWebSceneDataset(tmp_path / "port", True)
    ref = JWebSceneDataset(tmp_path / "jax", load_depth=True)
    assert len(port) == len(port_by_jax) == len(ref) == 5
    for i in range(5):
        frames_equal(port[i], ref[i])
        frames_equal(port[i], port_by_jax[i])
        assert port[i].infos.view_id == ref[i].infos.view_id == i
    assert sum(len(o.object_datas) for o in map(port.__getitem__, range(5))) >= 5
    # Ranks render disjoint shards; a rerun skips the shards it has.
    s0 = gen.generate(tdb, tmp_path / "multi", rank=0, world_size=2, **kw)
    s1 = gen.generate(tdb, tmp_path / "multi", rank=1, world_size=2, **kw)
    assert [p.name for p in s0] == ["shard-000000.tar"] and [p.name for p in s1] == ["shard-000001.tar"]
    for name in ("shard-000000.tar", "shard-000001.tar"):
        assert (tmp_path / "multi" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    mtime = s0[0].stat().st_mtime_ns
    assert gen.generate(tdb, tmp_path / "multi", rank=0, world_size=2, **kw) == s0
    assert s0[0].stat().st_mtime_ns == mtime
    seen = []
    for obs in IterableWebSceneDataset(port, buffer_size=2, seed=0):
        seen.append(obs.infos.view_id)
        if len(seen) == 10:
            break
    assert set(seen) == set(range(5))


def test_generate_bop_tree_matches_jax(dbs, tmp_path):
    jdb, tdb = dbs
    kw = dict(n_frames=3, resolution=RES, n_obj_per_scene=3, f=120.0, frames_per_scene=2, seed=5)
    gen.generate_bop(tdb, gen._default_objects(), tmp_path / "port", **kw)
    jgen.generate_bop(jdb, jgen._default_objects(), tmp_path / "jax", **kw)
    for f in sorted((tmp_path / "jax" / "models").iterdir()):
        g = tmp_path / "port" / "models" / f.name
        if f.suffix == ".png":
            np.testing.assert_array_equal(read_png(g), np.asarray(Image.open(f)))
        else:
            assert g.read_text() == f.read_text(), f.name
    for scene in ("000000", "000001"):
        a = json.loads((tmp_path / "jax/test" / scene / "scene_gt.json").read_text())
        b = json.loads((tmp_path / "port/test" / scene / "scene_gt.json").read_text())
        assert a.keys() == b.keys()
        for v in a:
            assert [r["obj_id"] for r in a[v]] == [r["obj_id"] for r in b[v]]
            for ra, rb in zip(a[v], b[v]):
                np.testing.assert_allclose(rb["cam_R_m2c"], ra["cam_R_m2c"], atol=1e-6)
                np.testing.assert_allclose(rb["cam_t_m2c"], ra["cam_t_m2c"], atol=1e-3)
        for name in ("scene_camera", "scene_gt_info"):
            assert json.loads((tmp_path / "port/test" / scene / f"{name}.json").read_text()) == \
                json.loads((tmp_path / "jax/test" / scene / f"{name}.json").read_text())
    for root in ("port", "jax"):
        port, ref = BOPDataset(tmp_path / root, load_depth=True), JBOPDataset(tmp_path / root, load_depth=True)
        assert len(port) == len(ref) == 3
        for i in range(3):
            frames_equal(port[i], ref[i])
    for i in range(3):
        frames_equal(BOPDataset(tmp_path / "port", load_depth=True)[i], BOPDataset(tmp_path / "jax", load_depth=True)[i])


def test_demo_datagen_first_frames_match_jax(tmp_path):
    """`demo_ar_baseline`'s dataset (demo world, 240x320, f=400, 2 objects,
    seed 123, realism): its first two frames from both generators, and
    beside the committed `runs/ar_dr/synthdemo` (made on a TPU)."""
    args = demo.parse_args([f"out_dir={tmp_path}", "n_frames=2", "device=cpu"])
    demo.generate_dataset(args, tmp_path / "synthdemo", "cpu")
    jdb, jobjs = jdemo.build_bop_world("demo")
    jgen.generate_bop(jdb, jobjs, tmp_path / "jax", n_frames=2, resolution=(240, 320), n_obj_per_scene=2, f=400.0,
                      frames_per_scene=4, seed=123)
    port = BOPDataset(tmp_path / "synthdemo", load_depth=True)
    jax_cpu = BOPDataset(tmp_path / "jax", load_depth=True)
    tpu = BOPDataset(ROOT / "runs/ar_dr/synthdemo", load_depth=True)
    for i in range(2):
        frames_equal(port[i], jax_cpu[i])
        frames_equal(port[i], tpu[i], visib_atol=1e-7)  # the TPU divides 4712 / 4712 to 1 - 6e-8
    assert sorted(p.name for p in (tmp_path / "synthdemo/models").iterdir()) == [
        "models_info.json", "obj_000001.ply", "obj_000001.png", "obj_000002.ply", "obj_000002.png"]
    shutil.rmtree(tmp_path)
