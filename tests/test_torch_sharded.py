"""Port vs JAX: the label-sharded mesh database and the device mesh
helpers (sharded inference: `tests/test_torch_sharded_inference.py`).

- `split_labels`, the shard layout and `local_index` equal the JAX
  package's (`meshes/sharded_db.py`) on 10 cubes of distinct sizes over 3
  shards (one shard padded with its last label); each shard's arrays equal
  the JAX package's slice of its stacked database, with forced pad
  targets; `sample_local_batch_indices` draws the JAX package's indices;
  `MeshDataBase.batched(n_vertices_pad=, n_faces_pad=)` pads to the
  targets and refuses targets below a mesh.
- A render from one shard with LOCAL indices is the render of the same
  labels from the whole database (bit for bit, the plain visibility pass).
- `parallel.mesh`: `make_mesh` raises past the devices there are,
  `batch_sharding` and `shard_batch` split the batch axis in order.
- No device fallback: with no card, `make_mesh()` (device type "cuda")
  and `distributed.local_device()` raise instead of returning the CPU.
"""

import numpy as np
import pytest
import torch

from megapose6d_tpu.meshes import MeshDataBase as JMeshDataBase
from megapose6d_tpu.meshes import RigidObject as JRigidObject
from megapose6d_tpu.meshes import RigidObjectDataset as JRigidObjectDataset
from megapose6d_tpu.meshes.io import make_cube
from megapose6d_tpu.meshes.sharded_db import ShardedMeshDB as JShardedMeshDB
from megapose6d_tpu.meshes.sharded_db import sample_local_batch_indices as j_sample
from megapose6d_tpu.meshes.sharded_db import split_labels as j_split_labels
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.meshes import mesh_db as tdb
from megapose6d_tpu_torch.meshes.sharded_db import ShardedMeshDB, sample_local_batch_indices, split_labels
from megapose6d_tpu_torch.ops import rasterizer_tiled as rt
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_batch

pin_f32()
N_OBJ, N_SHARDS, SEED = 10, 3, 3
PADS = dict(n_vertices_pad=32, n_faces_pad=16)
DB_KW = dict(max_faces=16, n_points=16, n_sym=2, align=8)
IMG = (72, 96)
K = np.asarray([[120.0, 0, 48], [0, 120.0, 36], [0, 0, 1]], np.float32)


def objects(pkg):
    rigid, dataset, cube = ((JRigidObject, JRigidObjectDataset, make_cube) if pkg == "jax"
                            else (tdb.RigidObject, tdb.RigidObjectDataset, tio.make_cube))
    return dataset([rigid(label=f"obj_{i:04d}", mesh=cube(0.01 + 0.001 * i)) for i in range(N_OBJ)])


@pytest.fixture(scope="module")
def dbs():
    jdb = JShardedMeshDB.build(objects("jax"), n_shards=N_SHARDS, seed=SEED, **PADS, **DB_KW)
    tdb_ = ShardedMeshDB.build(objects("torch"), n_shards=N_SHARDS, device_mesh="cpu", seed=SEED, **PADS, **DB_KW)
    return jdb, tdb_


def test_split_and_local_index_match_jax(dbs):
    jdb, tdb_ = dbs
    labels = [f"l{i}" for i in range(100)]
    assert split_labels(labels, 8, seed=3) == j_split_labels(labels, 8, seed=3)
    assert tdb_.per_shard == jdb.per_shard and tdb_.n_shards == jdb.n_shards
    assert tdb_.shard_labels == jdb.shard_labels
    assert any(len(s) < tdb_.per_shard for s in tdb_.shard_labels)  # a padded shard
    for sid in range(N_SHARDS):
        lab = jdb.shard_labels[sid]
        np.testing.assert_array_equal(tdb_.local_index(sid, lab), jdb.local_index(sid, lab))
        shard, jshard = tdb_.local_shard(sid), jdb.local_shard(sid)
        assert shard.labels == tuple(jshard.labels)
        for f in ("vertices", "faces", "face_valid", "points", "symmetries", "sym_valid", "diameters"):
            np.testing.assert_allclose(getattr(shard, f).numpy(), np.asarray(getattr(jshard, f)), atol=1e-7,
                                       err_msg=f)
    np.testing.assert_array_equal(sample_local_batch_indices(tdb_, 5, seed=1), j_sample(jdb, 5, seed=1))


def test_pad_targets():
    host = tdb.MeshDataBase.from_object_ds(objects("torch"), **{k: v for k, v in DB_KW.items() if k != "align"})
    jhost = JMeshDataBase.from_object_ds(objects("jax"), **{k: v for k, v in DB_KW.items() if k != "align"})
    db = host.batched(align=8, device="cpu", **PADS)
    jb = jhost.batched(align=8, **PADS)
    assert tuple(db.vertices.shape) == (N_OBJ, 32, 3) and tuple(db.faces.shape) == (N_OBJ, 16, 3)
    np.testing.assert_allclose(db.vertices.numpy(), np.asarray(jb.vertices), atol=1e-7)
    assert host.pad_targets(8) == (24, 16)  # a flat-shaded cube: 24 vertices, 12 faces
    for bad in (dict(n_vertices_pad=4), dict(n_faces_pad=8)):
        with pytest.raises(ValueError):
            host.batched(align=8, device="cpu", **bad)
    # Shards built apart need the targets.
    with pytest.raises(ValueError):
        ShardedMeshDB.build(objects("torch"), n_shards=N_SHARDS, device_mesh="cpu", shard_ids=[1], **DB_KW)
    one = ShardedMeshDB.build(objects("torch"), n_shards=N_SHARDS, device_mesh="cpu", seed=SEED, shard_ids=[1],
                              **PADS, **DB_KW)
    assert list(one.shards) == [1] and one.local_shard(1).vertices.shape[1:] == (32, 3)
    with pytest.raises(KeyError):
        one.local_shard(0)


def test_sharded_render_selects_local_labels(dbs):
    _, sdb = dbs
    whole = tdb.MeshDataBase.from_object_ds(objects("torch"), **{k: v for k, v in DB_KW.items() if k != "align"}
                                            ).batched(align=8, device="cpu", **PADS)
    T = torch.eye(4).expand(2, 4, 4).clone()
    T[:, 2, 3] = 0.3
    Kt = torch.as_tensor(K).expand(2, 3, 3)
    sizes = []
    for sid in range(N_SHARDS):
        labels = sdb.shard_labels[sid][:2]
        local = sdb.local_shard(sid).select(torch.as_tensor(sdb.local_index(sid, labels), dtype=torch.long))
        glob = whole.select(whole.label_to_index(labels))
        render = lambda m: rt.render_meshes_tiled(m.vertices, m.normals, m.colors, m.faces, m.face_valid,  # noqa
                                                  T, Kt, IMG, light_ambient=1.0, light_point=0.0)
        a, b = render(local), render(glob)
        assert torch.equal(a.rgb, b.rgb) and torch.equal(a.mask, b.mask)
        sizes.append(float(local.vertices[0].norm(dim=-1).max()))
    assert len(set(np.round(sizes, 6))) == N_SHARDS  # each shard's first label is its own


def test_mesh_helpers():
    assert make_mesh(1, device_type="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(2, device_type="cpu")
    assert batch_sharding(6, 3) == [slice(0, 2), slice(2, 4), slice(4, 6)]
    with pytest.raises(ValueError):
        batch_sharding(5, 2)
    parts = shard_batch(torch.arange(4.0), ["cpu", "cpu"])
    assert [p.tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0]]


def test_no_cpu_fallback_without_a_card(monkeypatch):
    from megapose6d_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        distributed.local_device()
    for n in (None, 1):
        with pytest.raises(ValueError, match="no CUDA card"):
            make_mesh(n)
