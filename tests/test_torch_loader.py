"""The port's batch loader (`data/loader.py`, a DataLoader over forkserver
workers): the batch contract and the per-worker seeds, inline against two
workers; `close()` twice; a worker that dies makes the loader raise.

Two workers take turns: batch k comes from worker k % 2, and is
its (k // 2)-th, so each is held bit for bit against `factory(seed +
1000003 (i + 1))` run inline after seeding `random` and `np.random` with
that seed. The factory reads a webdataset tree written under `tmp_path`.
This file imports no JAX: the workers import it to unpickle the factory.
"""

import os

import numpy as np
import pytest
import torch

from megapose6d_tpu_torch.data.loader import ParallelBatchLoader, PoseBatchFactory, seed_host_rngs
from megapose6d_tpu_torch.data.pose_dataset import host_batch_to_torch
from megapose6d_tpu_torch.data.scene_dataset import ObservationInfos, SceneObservation
from megapose6d_tpu_torch.data.types import CameraData, ObjectData
from megapose6d_tpu_torch.data.web_scene_dataset import write_scene_ds_as_wds

H, W = 72, 96


@pytest.fixture(scope="module")
def wds_root(tmp_path_factory):
    rng = np.random.RandomState(0)
    frames = []
    for i in range(10):
        T = np.eye(4)
        T[:3, 3] = [0.01 * i, 0.0, 0.5]
        seg = np.zeros((H, W), np.uint32)
        seg[10 : 40 + i, 20:70] = 1
        frames.append(SceneObservation(
            rgb=rng.randint(0, 255, (H, W, 3), dtype=np.uint8), segmentation=seg,
            infos=ObservationInfos(scene_id="0", view_id=i),
            object_datas=[ObjectData(label=f"obj_00000{1 + i % 2}", TWO=T, unique_id=1,
                                     bbox_modal=np.array([20.0, 10.0, 70.0, 40.0 + i]), visib_fract=0.9)],
            camera_data=CameraData(K=np.asarray([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]), resolution=(H, W)),
        ))
    root = tmp_path_factory.mktemp("webdatasets")
    write_scene_ds_as_wds(iter(frames), root / "loadertest", frames_per_shard=4)
    return root


def _factory(root, batch_size=3):
    return PoseBatchFactory(dataset_names=("webdataset.loadertest",), labels=("obj_000001", "obj_000002"),
                            batch_size=batch_size, resize=(48, 64), min_area=10.0, data_dir=str(root))


def _inline(factory, seed, n):
    seed_host_rngs(seed)
    it = factory(seed)
    return [host_batch_to_torch(next(it)) for _ in range(n)]


def _equal(a, b):
    for k in ("rgbs", "K", "TCO", "bboxes", "mesh_idx"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_inline_loader_is_the_seeded_factory(wds_root):
    factory = _factory(wds_root)
    loader = ParallelBatchLoader(factory, n_workers=0, seed=5)
    got = [next(loader) for _ in range(3)]
    loader.close()
    for a, b in zip(got, _inline(factory, 5, 3)):
        _equal(a, b)
    b = got[0]
    assert b.rgbs.shape == (3, 48, 64, 3) and b.K.shape == (3, 3, 3) and b.TCO.shape == (3, 4, 4)
    assert b.bboxes.shape == (3, 4) and b.mesh_idx.dtype == torch.int64 and b.depths is None
    assert 0.0 <= float(b.rgbs.min()) and float(b.rgbs.max()) <= 1.0


def test_two_workers_take_turns_with_their_seeds(wds_root):
    factory = _factory(wds_root)
    with ParallelBatchLoader(factory, n_workers=2, seed=5) as loader:
        got = [next(loader) for _ in range(4)]
    want = {i: _inline(factory, 5 + 1000003 * (i + 1), 2) for i in range(2)}
    for k, batch in enumerate(got):
        _equal(batch, want[k % 2][k // 2])
    assert not torch.equal(got[0].rgbs, got[1].rgbs)


def test_close_is_idempotent(wds_root):
    loader = ParallelBatchLoader(_factory(wds_root), n_workers=1, seed=0)
    next(loader)
    workers = list(loader._iter._workers)
    loader.close()
    loader.close()
    assert all(not w.is_alive() for w in workers)
    inline = ParallelBatchLoader(_factory(wds_root), n_workers=0)
    inline.close()
    inline.close()


class _DyingFactory:
    """Yields nothing: the worker process exits at once."""

    def __call__(self, seed):
        os._exit(3)
        yield


def test_dead_worker_raises():
    loader = ParallelBatchLoader(_DyingFactory(), n_workers=1, seed=0)
    with pytest.raises(RuntimeError, match="exited unexpectedly|died|killed"):
        next(loader)
    loader.close()
