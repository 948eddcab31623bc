"""Port vs JAX: datasets by name (`data/datasets_cfg.py`), the object
scanners (`data/object_datasets.py`) and the ModelNet and pickle scene
datasets (`data/modelnet.py`).

Every name of the JAX package's `tests/test_datasets_cfg.py` (and the
ModelNet, `dir:`, webdataset and generic names) resolves, in both
packages, to the same frames: the same scene and view ids, equal rgb,
depth and segmentation arrays, the same labels, and poses and boxes
within 1e-12 (both read the same JSON); object datasets to the same labels,
mesh files, units and symmetries. Trees are built under `tmp_path`; the
`train_pbr` split keeps its rgb as JPEG, read by both packages' native
decoders (skipped without g++ and libjpeg).
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from megapose6d_tpu.data import datasets_cfg as jcfg
from megapose6d_tpu.data import modelnet as jmodelnet
from megapose6d_tpu.data.scene_dataset import ObservationInfos as JInfos
from megapose6d_tpu.data.scene_dataset import SceneObservation as JObs
from megapose6d_tpu.data.types import CameraData as JCam
from megapose6d_tpu.data.types import ObjectData as JObj
from megapose6d_tpu.data.web_scene_dataset import write_scene_ds_as_wds
from megapose6d_tpu.meshes import make_cube, save_ply
from megapose6d_tpu_torch import native
from megapose6d_tpu_torch.data import datasets_cfg as tcfg
from megapose6d_tpu_torch.data import modelnet as tmodelnet


def _write_bop_scene(ds_dir: Path, split: str, scene_id=1, n_views=3, ext="png", seed=0):
    rng = np.random.RandomState(seed)
    scene = ds_dir / split / f"{scene_id:06d}"
    for d in ("rgb", "depth", "mask_visib"):
        (scene / d).mkdir(parents=True, exist_ok=True)
    cam, gt, gt_info = {}, {}, {}
    for v in range(n_views):
        Image.fromarray(rng.randint(0, 256, (24, 32, 3), dtype=np.uint8)).save(scene / "rgb" / f"{v:06d}.{ext}")
        Image.fromarray(rng.randint(300, 900, (24, 32)).astype(np.uint16)).save(scene / "depth" / f"{v:06d}.png")
        mask = np.zeros((24, 32), np.uint8)
        mask[2 + v : 12, 2:12] = 255
        Image.fromarray(mask).save(scene / "mask_visib" / f"{v:06d}_000000.png")
        cam[str(v)] = {"cam_K": [100.0, 0, 16, 0, 100.0, 12, 0, 0, 1], "depth_scale": 0.1}
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        gt[str(v)] = [{"obj_id": 1 + v % 2, "cam_R_m2c": R.reshape(-1).tolist(), "cam_t_m2c": [1.0, -2.0, 400.0]}]
        gt_info[str(v)] = [{"bbox_visib": [2, 2 + v, 10, 10 - v], "bbox_obj": [1, 1, 12, 12], "visib_fract": 0.8}]
    (scene / "scene_camera.json").write_text(json.dumps(cam))
    (scene / "scene_gt.json").write_text(json.dumps(gt))
    (scene / "scene_gt_info.json").write_text(json.dumps(gt_info))


def _write_bop_models(ds_dir: Path, models="models", n=2):
    mdir = ds_dir / models
    mdir.mkdir(parents=True, exist_ok=True)
    info = {}
    for i in range(1, n + 1):
        save_ply(make_cube(0.02), mdir / f"obj_{i:06d}.ply")
        info[str(i)] = {"diameter": 40.0, "symmetries_discrete": [np.eye(4).reshape(-1).tolist()]}
    (mdir / "models_info.json").write_text(json.dumps(info))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The JAX test's tree, with depth and masks, plus hb, lm, itodd,
    tudl, a generic tree, ModelNet and a webdataset shard."""
    root = tmp_path_factory.mktemp("megapose_data")
    bop = root / "bop_datasets"
    ycbv = bop / "ycbv"
    _write_bop_scene(ycbv, "test")
    _write_bop_models(ycbv)
    (ycbv / "test_targets_bop19.json").write_text(json.dumps(
        [{"im_id": 0, "inst_count": 1, "obj_id": 1, "scene_id": 1},
         {"im_id": 2, "inst_count": 1, "obj_id": 1, "scene_id": 1}]))
    tless = bop / "tless"
    _write_bop_scene(tless, "test_primesense", seed=1)
    _write_bop_scene(tless, "train_primesense", seed=2)
    for m in ("models_cad", "models_eval", "models_reconst"):
        _write_bop_models(tless, m)
    (tless / "test_targets_bop19.json").write_text(json.dumps([{"im_id": 1, "inst_count": 1, "obj_id": 1,
                                                                "scene_id": 1}]))
    _write_bop_scene(ycbv, "train_pbr", ext="jpg", seed=3)
    _write_bop_scene(ycbv, "train_real", seed=4)
    _write_bop_scene(ycbv, "train_synt", seed=5)
    _write_bop_scene(bop / "hb", "test_primesense", seed=6)
    _write_bop_scene(bop / "hb", "val_primesense", seed=7)
    _write_bop_models(bop / "hb")
    _write_bop_scene(bop / "lm", "test", seed=8)
    _write_bop_models(bop / "lm")
    _write_bop_scene(bop / "lmo", "test", seed=9)
    _write_bop_scene(bop / "tudl", "train_real", seed=10)
    _write_bop_scene(bop / "mine", "test", seed=11)
    _write_bop_scene(bop / "mine", "train_real", seed=12)
    _write_bop_models(bop / "mine")
    for name in ("alpha", "beta", "gamma"):
        mdir = root / "gso" / "models_orig" / name / "meshes"
        mdir.mkdir(parents=True)
        (mdir / "model.obj").write_text("v 0 0 0\nv 0.01 0 0\nv 0.01 0.01 0\nv 0 0.01 0\nf 1 2 3\nf 1 3 4\n")
    for synset, model in (("02691156", "m1"), ("02691156", "m2"), ("03001627", "m3")):
        mdir = root / "shapenetcorev2" / synset / model / "models"
        mdir.mkdir(parents=True, exist_ok=True)
        (mdir / "model_normalized.obj").write_text("v 0 0 0\nv 0.01 0 0\nv 0.01 0.01 0\nf 1 2 3\n")
    _write_modelnet(root / "modelnet40")
    meshes = root / "meshes"
    meshes.mkdir()
    save_ply(make_cube(0.03), meshes / "box.ply")
    (meshes / "tri.obj").write_text("v 0 0 0\nv 0.01 0 0\nv 0.01 0.01 0\nf 1 2 3\n")
    rng = np.random.RandomState(13)
    frames = []
    for i in range(3):
        seg = np.zeros((24, 32), np.uint32)
        seg[4:14, 5:15] = 1
        T = np.eye(4)
        T[:3, 3] = [0.01 * i, 0.0, 0.5]
        frames.append(JObs(
            rgb=rng.randint(0, 256, (24, 32, 3), dtype=np.uint8), depth=np.full((24, 32), 0.5, np.float32),
            segmentation=seg, infos=JInfos(str(i), i),
            object_datas=[JObj(label="obj_000001", TWO=T, unique_id=1,
                               bbox_modal=np.array([5.0, 4, 15, 14]), visib_fract=0.9)],
            camera_data=JCam(K=np.array([[100.0, 0, 16], [0, 100.0, 12], [0, 0, 1]]), resolution=(24, 32))))
    write_scene_ds_as_wds(frames, root / "wds" / "shards", frames_per_shard=2)
    return root


def _write_modelnet(root: Path):
    cat = root / "chair"
    (cat / "test").mkdir(parents=True)
    K = [[300.0, 0, 64], [0, 300.0, 48], [0, 0, 1]]
    (cat / "camera.json").write_text(json.dumps({"K": K, "resolution": [96, 128]}))
    rng = np.random.RandomState(0)
    for model, view in (("chair_0001", 0), ("chair_0001", 1), ("chair_0002", 0)):
        key = f"{model}_{view}"
        Image.fromarray(rng.randint(0, 255, (96, 128, 3), dtype=np.uint8)).save(cat / "test" / f"{key}-color.png")
        Image.fromarray(np.full((96, 128), 800 + view, np.uint16)).save(cat / "test" / f"{key}-depth.png")
        T = np.eye(4)
        T[2, 3] = 0.8
        np.savetxt(cat / "test" / f"{key}-pose.txt", T)
        T[0, 3] = 0.02
        np.savetxt(cat / "test" / f"{key}-pose_init.txt", T)
        (cat / "test" / f"{model}.obj").write_text("v 0 0 0\nv 0.01 0 0\nv 0.01 0.01 0\nf 1 2 3\n")


def _same_frames(a, b):
    assert len(a) == len(b) and len(b) > 0
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert (x.infos.scene_id, x.infos.view_id) == (y.infos.scene_id, y.infos.view_id)
        for k in ("rgb", "depth", "segmentation"):
            u, v = getattr(x, k), getattr(y, k)
            assert (u is None) == (v is None), k
            if u is not None:
                assert u.dtype == v.dtype and u.shape == v.shape, k
                np.testing.assert_array_equal(u, v, err_msg=k)
        np.testing.assert_allclose(x.camera_data.K, y.camera_data.K, atol=1e-12)
        assert tuple(x.camera_data.resolution) == tuple(y.camera_data.resolution)
        assert [o.label for o in x.object_datas] == [o.label for o in y.object_datas]
        for o, p in zip(x.object_datas, y.object_datas):
            for k in ("TWO", "TWO_init", "bbox_modal", "bbox_amodal"):
                u, v = getattr(o, k, None), getattr(p, k, None)
                assert (u is None) == (v is None), k
                if u is not None:
                    np.testing.assert_allclose(u, v, atol=1e-12, err_msg=k)
            assert o.visib_fract == p.visib_fract and o.unique_id == p.unique_id


SCENE_NAMES = [
    ("ycbv.bop19", "bop"), ("tless.bop19", "bop"), ("hb.bop19", "bop"), ("lm.bop19", "bop"), ("lmo.bop19", "bop"),
    ("tless.primesense.train", "bop"), ("tless.primesense.test", "bop"), ("ycbv.train.real", "bop"),
    ("ycbv.train.synt", "bop"), ("ycbv.test", "bop"), ("lmo.test", "bop"), ("hb.val", "bop"),
    ("tudl.train.real", "bop"), ("ycbv.pbr", "bop"), ("mine", "bop"), ("mine.test", "bop"),
    ("mine.train_real", "bop"), ("mine.bop19", "bop"), ("modelnet.chair.test", "root"),
    ("webdataset.shards", "wds"),
]


@pytest.mark.parametrize("name,where", SCENE_NAMES, ids=[n for n, _ in SCENE_NAMES])
@pytest.mark.parametrize("depth", [False, True], ids=["rgb", "depth"])
def test_scene_names_match_jax(data_root, name, where, depth):
    if name == "ycbv.pbr" and not native.available():
        pytest.skip("the train_pbr split is JPEG: the native decoder (g++, libjpeg) did not build")
    data_dir = {"bop": data_root / "bop_datasets", "root": data_root, "wds": data_root / "wds"}[where]
    a = jcfg.make_scene_dataset(name, load_depth=depth, data_dir=data_dir)
    b = tcfg.make_scene_dataset(name, load_depth=depth, data_dir=data_dir)
    _same_frames(a, b)


def test_n_frames_and_unknown_names(data_root):
    bop = data_root / "bop_datasets"
    b = tcfg.make_scene_dataset("tless.primesense.train", data_dir=bop, n_frames=2)
    _same_frames(jcfg.make_scene_dataset("tless.primesense.train", data_dir=bop, n_frames=2), b)
    assert len(b) == 2
    with pytest.raises(FileNotFoundError):
        tcfg.make_scene_dataset("nope.bop19", data_dir=bop)
    with pytest.raises(ValueError):
        tcfg.make_object_dataset("nope_objects", data_dir=bop)
    with pytest.raises(ValueError):
        tcfg.make_scene_dataset("ycbv.not_a_variant", data_dir=bop)


def _same_objects(a, b):
    assert [o.label for o in a.objects] == [o.label for o in b.objects] and a.objects
    for o, p in zip(a.objects, b.objects):
        assert Path(o.mesh_path) == Path(p.mesh_path) and o.mesh_units == p.mesh_units
        assert len(o.symmetries_discrete) == len(p.symmetries_discrete)
        for s, t in zip(o.symmetries_discrete, p.symmetries_discrete):
            np.testing.assert_array_equal(np.asarray(s.pose), np.asarray(t.pose))


OBJECT_NAMES = [
    ("ycbv", "bop"), ("ycbv.panda3d", "bop"), ("tless.cad", "bop"), ("tless.eval", "bop"), ("tless.reconst", "bop"),
    ("lm", "bop"), ("lmo", "bop"), ("hb", "bop"), ("mine", "bop"), ("mine.bop19", "bop"), ("gso.orig", "root"),
    ("gso.nobjects=2.orig", "root"), ("gso.panda3d", "root"), ("shapenet.orig", "root"),
    ("shapenet.filters=remove_modelnet.orig", "root"), ("modelnet.chair.test", "root"), ("dir:", "meshes"),
]


@pytest.mark.parametrize("name,where", OBJECT_NAMES, ids=[n for n, _ in OBJECT_NAMES])
def test_object_names_match_jax(data_root, name, where):
    if where == "meshes":
        name, data_dir = f"dir:{data_root / 'meshes'}", None
    else:
        data_dir = data_root / "bop_datasets" if where == "bop" else data_root
    _same_objects(jcfg.make_object_dataset(name, data_dir=data_dir), tcfg.make_object_dataset(name, data_dir=data_dir))


def test_obj_ds_info_and_tables():
    for name in ("ycbv.bop19", "tless.bop19", "lmo.bop19", "modelnet.chair.test"):
        assert tcfg.get_obj_ds_info(name) == jcfg.get_obj_ds_info(name)
    assert tcfg.BOP_DATASET_NAMES == jcfg.BOP_DATASET_NAMES and tcfg._BOP19 == jcfg._BOP19
    assert tcfg._BOP_EXTRA_SPLITS == jcfg._BOP_EXTRA_SPLITS and tcfg._PBR_DATASETS == jcfg._PBR_DATASETS
    from megapose6d_tpu import bop_config as jb
    from megapose6d_tpu_torch import bop_config as tb

    assert tb.BOP_CONFIG == jb.BOP_CONFIG


def test_modelnet_frames_and_pickles(data_root, tmp_path):
    a = jmodelnet.DeepImModelNetDataset(data_root / "modelnet40", "chair", load_depth=True, n_objects=2)
    b = tmodelnet.DeepImModelNetDataset(data_root / "modelnet40", "chair", load_depth=True, n_objects=2)
    _same_frames(a, b)
    np.testing.assert_array_equal(jmodelnet._bbox_from_pose(a[1].object_datas[0].TWO, a.K, (96, 128)),
                                  tmodelnet._bbox_from_pose(b[1].object_datas[0].TWO, b.K, (96, 128)))
    obs = b[0]
    path = tmp_path / "obs.pkl"
    path.write_bytes(pickle.dumps(obs))
    ds = tmodelnet.PickleSceneDataset([path])
    assert len(ds) == 1 and np.array_equal(ds[0].rgb, obs.rgb)
