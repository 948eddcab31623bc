"""Port vs JAX: `data/pose_dataset.py` (PoseDataset, make_data_from_obs,
the visibility / area / label filters, collate_pose_data) and the first
batches of `PoseBatchFactory(...)(seed)` (`data/loader.py`) on a BOP tree
and a webdataset tree built under `tmp_path` by the JAX package's writers.

With `random` and `np.random` seeded alike, both packages draw the same
frames, augmentations and objects, so every batch is held bit for bit:
rgbs, K, TCO, bboxes and mesh_idx (tolerance none; the augmentations are
PIL's arithmetic exactly, `tests/test_torch_augmentations.py`). The
factory runs with RGB augmentation and without depth (the JAX package's
depth stack raises on its blur, as the port's does).
"""

import random

import numpy as np
import pytest
import torch

from megapose6d_tpu.data import loader as jloader
from megapose6d_tpu.data import pose_dataset as jpd
from megapose6d_tpu.data.bop_writer import write_scene_ds_as_bop
from megapose6d_tpu.data.scene_dataset import ObservationInfos as JInfos
from megapose6d_tpu.data.scene_dataset import SceneObservation as JObs
from megapose6d_tpu.data.types import CameraData as JCam
from megapose6d_tpu.data.types import ObjectData as JObj
from megapose6d_tpu.data.web_scene_dataset import write_scene_ds_as_wds
from megapose6d_tpu_torch.data import loader as tloader
from megapose6d_tpu_torch.data import pose_dataset as tpd
from megapose6d_tpu_torch.data.scene_dataset import ObservationInfos as TInfos
from megapose6d_tpu_torch.data.scene_dataset import SceneObservation as TObs
from megapose6d_tpu_torch.data.types import CameraData as TCam
from megapose6d_tpu_torch.data.types import ObjectData as TObj

LABELS = ("obj_000001", "obj_000002", "obj_000003")


def _frame(i, rng, h, w, types=(JObs, JObj, JCam, JInfos)):
    """A frame of 3 objects: boxes of all sizes (some below the area
    filter), one object often barely visible."""
    Obs, Obj, Cam, Infos = types
    rgb = np.clip(np.cumsum(rng.randint(-15, 16, (h, w, 3)), 1) + 128, 0, 255).astype(np.uint8)
    seg = np.zeros((h, w), np.uint32)
    objs = []
    for n in range(3):
        s = rng.randint(3, h // 2)
        y0, x0 = rng.randint(0, h - s), rng.randint(0, w - s)
        seg[y0 : y0 + s, x0 : x0 + s] = n + 1
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * np.array([1, 1, 1])
        if np.linalg.det(T[:3, :3]) < 0:
            T[:3, 0] *= -1
        T[:3, 3] = [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), rng.uniform(0.4, 0.9)]
        objs.append(Obj(label=LABELS[(i + n) % 3], TWO=T, unique_id=n + 1,
                        bbox_modal=np.array([x0, y0, x0 + s, y0 + s], np.float64),
                        bbox_amodal=np.array([x0, y0, x0 + s, y0 + s], np.float64),
                        visib_fract=float(rng.choice([0.01, 0.5, 0.9]))))
    K = np.array([[200.0, 0, w / 2 - 0.5], [0, 200.0, h / 2 - 0.5], [0, 0, 1]])
    return Obs(rgb=rgb, depth=rng.uniform(0.4, 1.0, (h, w)).astype(np.float32), segmentation=seg,
               infos=Infos(str(i // 4), i), object_datas=objs, camera_data=Cam(K=K, resolution=(h, w)))


def _pair(i, h=120, w=200):
    return (_frame(i, np.random.RandomState(i), h, w),
            _frame(i, np.random.RandomState(i), h, w, (TObs, TObj, TCam, TInfos)))


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _same_pose_data(a, b):
    assert a.label == b.label
    for k in ("rgb", "K", "TCO", "bbox", "depth"):
        u, v = getattr(a, k), getattr(b, k)
        assert (u is None) == (v is None), k
        if u is not None:
            assert u.dtype == v.dtype, k
            np.testing.assert_array_equal(u, v, err_msg=k)


CASES = {
    "resize_only": dict(resize=(60, 80), apply_rgb_augmentation=False),
    "rgb_aug": dict(resize=(60, 80)),
    "min_area_labels": dict(resize=(96, 128), min_area=300.0, keep_labels_set={"obj_000001", "obj_000003"}),
    "depth": dict(resize=(60, 80), depth_supported=True, apply_rgb_augmentation=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_make_data_from_obs_matches_jax(case):
    jds, tds = jpd.PoseDataset(None, **CASES[case]), tpd.PoseDataset(None, **CASES[case])
    n_invalid = 0
    for i in range(12):
        jo, to = _pair(i)
        _seed(i)
        try:
            a = jds.make_data_from_obs(jo)
        except jpd.NoValidObjectError:
            a = None
        sa = (random.random(), np.random.random())
        _seed(i)
        try:
            b = tds.make_data_from_obs(to)
        except tpd.NoValidObjectError:
            b = None
        assert (a is None) == (b is None)
        assert sa == (random.random(), np.random.random())
        if a is None:
            n_invalid += 1
            continue
        _same_pose_data(a, b)
    if case == "min_area_labels":
        assert n_invalid > 0  # the filters did reject some frames


def test_filters():
    ds = tpd.PoseDataset(None, resize=(120, 200), apply_rgb_augmentation=False, min_area=100.0,
                         keep_labels_set={"obj_000002"})
    _, obs = _pair(0)
    for o in obs.object_datas:
        o.label, o.visib_fract = "obj_000002", 0.9
    obs.object_datas[0].bbox_modal = np.array([0.0, 0, 9, 9])  # 81 px^2 < min_area
    obs.object_datas[1].visib_fract = 0.04  # < 5% visible
    obs.object_datas[2].bbox_modal = None
    assert ds._valid_objects(obs) == []
    with pytest.raises(tpd.NoValidObjectError):
        ds.make_data_from_obs(obs)
    obs.object_datas[1].visib_fract = 0.05
    assert ds._valid_objects(obs) == [obs.object_datas[1]]
    obs.object_datas[1].label = "obj_000001"
    assert ds._valid_objects(obs) == []
    with pytest.raises(ValueError, match="no valid data after 3 attempts"):
        ds.find_valid_data(iter([obs] * 3), n_attempts=3)


@pytest.mark.parametrize("depth", [False, True], ids=["rgb", "rgbd"])
def test_collate_matches_jax(depth):
    kw = dict(resize=(60, 80), apply_rgb_augmentation=False, depth_supported=depth)
    jds, tds = jpd.PoseDataset(None, **kw), tpd.PoseDataset(None, **kw)
    label_to_idx = {l: i for i, l in enumerate(LABELS)}
    pairs = [_pair(i) for i in range(4)]
    for obs in (o for p in pairs for o in p):
        for obj in obs.object_datas:
            obj.visib_fract = 0.9
    _seed(0)
    ja = [jds.find_valid_data(iter([p[0]] * 5)) for p in pairs]
    _seed(0)
    ta = [tds.find_valid_data(iter([p[1]] * 5)) for p in pairs]
    for scale in (1, 0):  # 0: an all-black batch keeps its values (max <= 1.5)
        for s in ja + ta:
            s.rgb = s.rgb * scale
        a, b = jpd.collate_pose_data(ja, label_to_idx), tpd.collate_pose_data(ta, label_to_idx)
        for k in ("rgbs", "K", "TCO", "bboxes", "mesh_idx", "depths"):
            u, v = getattr(a, k), getattr(b, k)
            assert (u is None) == (v is None) and (u is None) == (not depth and k == "depths"), k
            if u is not None:
                u = np.asarray(u)
                assert u.dtype == v.dtype, k
                np.testing.assert_array_equal(u, v, err_msg=k)
    t = tpd.host_batch_to_torch(b)
    assert t.mesh_idx.dtype == torch.int64 and t.rgbs.dtype == torch.float32
    assert np.shares_memory(t.rgbs.numpy(), b.rgbs) and (t.depths is None) == (not depth)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A BOP tree (120x200 frames) and a webdataset tree (96x128, shards of
    5), 12 frames each, written by the JAX package."""
    root = tmp_path_factory.mktemp("pose_trees")
    write_scene_ds_as_bop(iter([_frame(i, np.random.RandomState(i), 120, 200) for i in range(12)]),
                          root / "bop" / "trainset", split="test")
    write_scene_ds_as_wds(iter([_frame(i, np.random.RandomState(50 + i), 96, 128) for i in range(12)]),
                          root / "wds" / "trainset", frames_per_shard=5)
    return root


@pytest.mark.parametrize("kind", ["bop", "wds"])
def test_factory_batches_match_jax(trees, kind):
    name = "trainset.bop19" if kind == "bop" else "webdataset.trainset"
    kw = dict(dataset_names=(name, name), labels=LABELS[:2], batch_size=4, resize=(60, 80), min_area=50.0,
              data_dir=str(trees / kind))
    seed = 17
    _seed(seed)
    it = jloader.PoseBatchFactory(**kw)(seed)
    want = [next(it) for _ in range(3)]
    state = (random.random(), np.random.random())
    _seed(seed)
    it = tloader.PoseBatchFactory(**kw)(seed)
    got = [next(it) for _ in range(3)]
    assert state == (random.random(), np.random.random())
    for a, b in zip(want, got):
        for k in ("rgbs", "K", "TCO", "bboxes", "mesh_idx"):
            u = np.asarray(getattr(a, k))
            v = getattr(b, k)
            assert u.dtype == v.dtype and u.shape == v.shape, k
            np.testing.assert_array_equal(u, v, err_msg=k)
        assert b.depths is None and b.rgbs.shape == (4, 60, 80, 3)
    assert len({tuple(b.mesh_idx.tolist()) for b in got} | {0}) > 1
