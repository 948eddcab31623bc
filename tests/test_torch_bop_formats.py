"""Port vs JAX: BOP scenes whose frames are JPEG or grey TIFF, JPEG
backgrounds, and the committed image fixtures.

A BOP tree is built under `tmp_path` from the committed synthdemo set three
times: its `rgb/*.png`, the committed JPEG copies (`rgb/*.jpg`, quality 95,
4:2:0, as BOP's `train_pbr`) and the committed grey TIFFs (`gray/*.tif`, as
ITODD). The port's `BOPDataset` gives the JAX `BOPDataset`'s observations
array for array (rgb, depth, segmentation) and the same cameras and
objects, with the libjpeg route and with it made unavailable (`jpeg.cc`).
`ReplaceBackgroundTransform` over JPEG backgrounds equals the JAX
transform under the same seeds, bit for bit (the tolerance PR 11 held the
bicubic resize to), and so do the batches of `PoseBatchFactory(...,
background_paths=)` and the JAX package's `PoseDataset(...,
apply_background_augmentation=True)` over the JPEG frames. `tests/data/torch_images/hashes.json` equals PIL's
decode of every committed JPEG and TIFF fixture and libpng's of every PNG,
the port decodes each to its hash, and the fixtures stay within 1.5 MB.
"""

import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest

from megapose6d_tpu.data import augmentations as ja
from megapose6d_tpu.data import datasets_cfg as jcfg
from megapose6d_tpu.data import pose_dataset as jpd
from megapose6d_tpu.data import scene_dataset as jsd
from megapose6d_tpu.data.bop_scene_dataset import BOPDataset as JBOPDataset
from megapose6d_tpu_torch import native
from megapose6d_tpu_torch.data import augmentations as ta
from megapose6d_tpu_torch.data.bop_scene_dataset import BOPDataset
from megapose6d_tpu_torch.data.loader import PoseBatchFactory
from tests.test_torch_augmentations import _apply, _obs_pair, _same
from tests.test_torch_datasets_cfg import _same_frames
from tests.torch_image_fixtures import OUT, SYNTHDEMO, array_hash, reference_decode

HASHES = json.loads((OUT / "hashes.json").read_text())
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="jpeg.cc needs g++")


def _tree(root: Path, kind: str) -> Path:
    """`root/synthdemo/test/<scene>` for scenes 0 and 1 (only 0, which the
    grey fixtures cover, for "tif"), with the frames of `kind`."""
    scenes = ["000000"] if kind == "tif" else ["000000", "000001"]
    for scene in scenes:
        src, dst = SYNTHDEMO / "test" / scene, root / "synthdemo/test" / scene
        dst.mkdir(parents=True)
        for name in ("scene_camera.json", "scene_gt.json", "scene_gt_info.json"):
            shutil.copy(src / name, dst / name)
        for d in ("depth", "mask_visib"):
            shutil.copytree(src / d, dst / d)
        if kind == "png":
            shutil.copytree(src / "rgb", dst / "rgb")
        elif kind == "jpg":
            shutil.copytree(OUT / "bop/synthdemo_jpg/test" / scene / "rgb", dst / "rgb")
        else:
            shutil.copytree(OUT / "bop/itodd_gray/test" / scene / "gray", dst / "gray")
    return root / "synthdemo"


@needs_gxx
@pytest.mark.parametrize("kind", ["png", "jpg", "tif"])
@pytest.mark.parametrize("route", ["default", "jpeg.cc"])
def test_bop_frames_match_jax(tmp_path, monkeypatch, kind, route):
    ds_dir = _tree(tmp_path, kind)
    want = JBOPDataset(ds_dir, split="test", load_depth=True)
    if route == "jpeg.cc":
        monkeypatch.setitem(native._libs, "decode", None)
    got = BOPDataset(ds_dir, split="test", load_depth=True)
    _same_frames(want, got)
    if kind == "tif":  # ITODD: a grey frame repeated to three channels
        rgb = got[0].rgb
        assert rgb.shape == (240, 320, 3) and (rgb[..., 0] == rgb[..., 2]).all()


@needs_gxx
@pytest.mark.parametrize("route", ["default", "jpeg.cc"])
def test_jpeg_backgrounds_match_jax(tmp_path, monkeypatch, route):
    """`ReplaceBackgroundTransform` over every JPEG fixture, and
    `VOCBackgroundAugmentation` over a VOC layout of them."""
    paths = sorted((OUT / "jpeg").glob("*.jpg"))
    (tmp_path / "JPEGImages").mkdir()
    for p in paths:
        shutil.copy(p, tmp_path / "JPEGImages" / p.name)
    if route == "jpeg.cc":
        monkeypatch.setitem(native._libs, "decode", None)
    for seed in range(len(paths)):
        jo, to = _obs_pair(seed)
        _same(_apply(ja.ReplaceBackgroundTransform(paths), jo, seed),
              _apply(ta.ReplaceBackgroundTransform(paths), to, seed))
        jo, to = _obs_pair(seed + 100)
        _same(_apply(ja.VOCBackgroundAugmentation(tmp_path), jo, seed),
              _apply(ta.VOCBackgroundAugmentation(tmp_path), to, seed))


@needs_gxx
def test_factory_with_jpeg_backgrounds_matches_jax(tmp_path, monkeypatch):
    """Two scenes of JPEG frames, JPEG backgrounds, 3 batches of 4 at 60x80
    from one worker seed: the JAX package's composition of its factory with
    `apply_background_augmentation=True`, and the port's factory."""
    _tree(tmp_path, "jpg")
    monkeypatch.setitem(native._libs, "decode", None)
    paths = tuple(str(p) for p in sorted((OUT / "jpeg").glob("*.jpg")))
    labels = ("obj_000001", "obj_000002")
    seed = 23

    def jax_batches():
        scenes = jsd.RandomIterableSceneDataset(jcfg.make_scene_dataset("synthdemo.bop19", data_dir=tmp_path),
                                                seed=seed)
        obs = iter(jsd.IterableMultiSceneDataset([scenes], seed=seed))
        ds = jpd.PoseDataset(None, resize=(60, 80), min_area=50.0, keep_labels_set=set(labels),
                             apply_background_augmentation=True, background_image_paths=paths)
        return ds.iter_batches(obs, 4, {l: i for i, l in enumerate(labels)})

    random.seed(seed)
    np.random.seed(seed)
    it = jax_batches()
    want = [next(it) for _ in range(3)]
    random.seed(seed)
    np.random.seed(seed)
    it = PoseBatchFactory(dataset_names=("synthdemo.bop19",), labels=labels, batch_size=4, resize=(60, 80),
                          min_area=50.0, data_dir=str(tmp_path), background_paths=paths)(seed)
    got = [next(it) for _ in range(3)]
    for a, b in zip(want, got):
        for k in ("rgbs", "K", "TCO", "bboxes", "mesh_idx"):
            np.testing.assert_array_equal(np.asarray(getattr(a, k)), getattr(b, k), err_msg=k)
    random.seed(seed)
    np.random.seed(seed)
    it = PoseBatchFactory(dataset_names=("synthdemo.bop19",), labels=labels, batch_size=4, resize=(60, 80),
                          min_area=50.0, data_dir=str(tmp_path))(seed)
    assert any(not np.array_equal(next(it).rgbs, b.rgbs) for b in got)  # the backgrounds were drawn


def test_committed_hashes_equal_pil_decode():
    """PIL's decode for a JPEG or TIFF, libpng's (the JAX package's native
    decoder) for a PNG, as `tests/torch_image_fixtures.reference_decode`."""
    files = sorted(p for p in OUT.rglob("*") if p.is_file() and p.name != "hashes.json")
    assert sorted(HASHES) == [str(p.relative_to(OUT)) for p in files]
    for p in files:
        rel = str(p.relative_to(OUT))
        assert array_hash(reference_decode(rel, p.read_bytes())) == HASHES[rel], p
    assert sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file()) <= 1.5e6


@needs_gxx
def test_port_decodes_every_fixture_to_its_hash(monkeypatch):
    monkeypatch.setitem(native._libs, "decode", None)  # jpeg.cc and tiff.py, as on a machine without libjpeg
    datas = {rel: (OUT / rel).read_bytes() for rel in HASHES}
    for rel, data in datas.items():
        assert array_hash(native.decode_image(data)) == HASHES[rel], rel
    batch = native.decode_batch(list(datas.values()), n_threads=4)
    assert [array_hash(a) for a in batch] == [HASHES[rel] for rel in datas]
