"""The port's OCDBT store (`utils/ocdbt.py`) and orbax reader
(`interop/orbax.py`) against tensorstore and the JAX package.

  - every committed checkpoint: `list()` equals tensorstore's OCDBT key
    list, and every value read equals tensorstore's bytes;
  - stores tensorstore writes here: a b-tree of height 4 (nodes of at most
    300 bytes: interior nodes, prefix-compressed keys, inline and indirect
    values), and 12 commits under a version tree of arity 2 (version tree
    nodes), every generation read as tensorstore reads it;
  - `read_checkpoint` equals the JAX package's restore bit for bit (same
    dtype): `load_checkpoint` of `coarse_dr` (params and step),
    `refiner_dr@24000` (params only), `refiner_dr@27000` (params,
    opt_state and step), `load_detector` of `detector_long`
    (`checkpoints/final`), and a checkpoint that the JAX package's
    `save_checkpoint` writes under `tmp_path` at a small width;
  - `tests/data/torch_checkpoints/hashes.json` equals tensorstore's arrays
    and the port's reads;
  - a bad CRC-32C, a missing data file, a missing chunk, filters and
    other compressors raise.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ts = pytest.importorskip("tensorstore")

from megapose6d_tpu_torch.interop.orbax import array_leaves, read_checkpoint  # noqa: E402
from megapose6d_tpu_torch.utils.ocdbt import OcdbtStore  # noqa: E402
from tests import torch_checkpoint_hashes as hashes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RUNS = ROOT / "runs"
CHECKPOINTS = hashes.checkpoint_dirs()


def kvstore(path: Path, **spec):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path.absolute()}", **spec}).result()


def same_store(path: Path, generation: int | None = None) -> int:
    """The port's keys and values of `path` against tensorstore's; returns
    the number of keys."""
    kv = kvstore(path, **({} if generation is None else {"version": generation}))
    store = OcdbtStore(path, generation)
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.list() == keys
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    return len(keys)


def test_checkpoints_list_and_read_as_tensorstore():
    assert len(CHECKPOINTS) == 9
    n = {str(p.relative_to(RUNS)): same_store(p) for p in CHECKPOINTS}
    assert n["refiner_dr/checkpoints/epoch_27000"] == 408 and n["detector_long/checkpoints/final"] == 92


def test_tall_btree_and_version_tree_written_by_tensorstore(tmp_path):
    tall = tmp_path / "tall"
    kv = kvstore(tall, config={"max_decoded_node_bytes": 300, "compression": {"id": "zstd", "level": 5}})
    with ts.Transaction() as txn:
        for i in range(200):
            kv.with_transaction(txn)[f"key/{i:04d}/name"] = b"v%d" % i * (i % 7) + (b"x" * 2000 if i % 10 == 0 else b"")
    assert OcdbtStore(tall).version.root_height >= 2
    assert same_store(tall) == 200
    versions = tmp_path / "versions"
    kv = kvstore(versions, config={"version_tree_arity_log2": 1})
    for i in range(12):
        kv[f"k{i}"] = b"val%d" % i
    assert same_store(versions) == 12
    for generation in range(1, 14):  # generation 1 is the empty store
        assert same_store(versions, generation) == generation - 1
    with pytest.raises(KeyError):
        OcdbtStore(versions, 14)


def flat_jax(tree) -> dict[str, np.ndarray]:
    """A JAX pytree's array leaves by orbax's names (keys joined by ".")."""
    def name(k):
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(name(k) for k in path): v if isinstance(v, int) else np.asarray(v) for path, v in leaves}


def assert_same_arrays(got: dict, want: dict):
    """Equal bit for bit with the same dtype and shape; where the JAX
    restore gives a Python int (a `step` whose target was an int), the
    port's integer scalar (the stored dtype) holds its value."""
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], int):
            assert got[k].dtype.kind == "i" and got[k].shape == () and int(got[k]) == want[k], k
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def jax_state(run: str | None = None, cfg=None, seed: int = 0):
    """A JAX `TrainState` of `runs/<run>`'s model and optimizer (or of
    `cfg`'s), initialised from `seed` with the render bypassed."""
    from megapose6d_tpu.meshes import MeshDataBase, RigidObject, RigidObjectDataset, make_cube
    from megapose6d_tpu.models import pose_predictor as jpp
    from megapose6d_tpu.training.config import load_config
    from megapose6d_tpu.training.train import TrainState, make_optimizer

    cfg = cfg or load_config(RUNS / run / "config.json")
    model = jpp.PosePredictor(jpp.PosePredictorConfig(**cfg.model_config_kwargs()))
    tiny = MeshDataBase.from_object_ds(RigidObjectDataset([RigidObject(label="cube", mesh=make_cube(0.04))]),
                                       max_faces=64, n_points=16, n_sym=2).batched(align=16)
    with jpp.skip_render_for_init():
        params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1,) + tuple(cfg.input_resize) + (3,)),
                                     jnp.eye(3)[None] * 100.0, jnp.eye(4)[None].at[0, 2, 3].set(0.5),
                                     tiny.select(jnp.zeros((1,), jnp.int32)))
    return TrainState.create(apply_fn=model.apply, params=params, tx=make_optimizer(cfg, 1))


@pytest.fixture(scope="module")
def refiner_state():
    return jax_state("refiner_dr")


def restored_tree(state) -> dict:
    return {"params": state.params, "opt_state": state.opt_state, "step": state.step}


def test_coarse_dr_equals_load_checkpoint():
    """A params-and-step checkpoint: the JAX restore takes its fallback."""
    from megapose6d_tpu.training.train import load_checkpoint

    state, epoch = load_checkpoint(RUNS / "coarse_dr", jax_state("coarse_dr"))
    got = read_checkpoint(RUNS / "coarse_dr/checkpoints/epoch_5000")
    assert epoch == 5000 and set(got) == {"params", "step"}
    assert_same_arrays(array_leaves(got), flat_jax({"params": state.params, "step": state.step}))


def test_refiner_dr_params_only_and_full(refiner_state):
    from megapose6d_tpu.training.train import load_checkpoint

    state, _ = load_checkpoint(RUNS / "refiner_dr", refiner_state, epoch=24000, params_only=True)
    got = read_checkpoint(RUNS / "refiner_dr/checkpoints/epoch_24000", prefixes=["params"])
    assert set(got) == {"params"}
    assert_same_arrays(array_leaves(got), flat_jax({"params": state.params}))
    state, _ = load_checkpoint(RUNS / "refiner_dr", refiner_state, epoch=27000)
    got = read_checkpoint(RUNS / "refiner_dr/checkpoints/epoch_27000")
    assert got["opt_state"][0] is None and set(got["opt_state"][1][0]) == {"count", "mu", "nu"}
    assert int(got["step"]) == 27000 and got["step"].shape == () and got["step"].dtype == np.int32
    assert_same_arrays(array_leaves(got), flat_jax(restored_tree(state)))


def test_detector_final_equals_load_detector():
    from megapose6d_tpu.evaluation.evaluation import load_detector

    det = load_detector(RUNS / "detector_long")
    got = read_checkpoint(RUNS / "detector_long/checkpoints/final")
    assert_same_arrays(array_leaves(got["params"]), flat_jax(det.params))


def test_a_checkpoint_the_jax_package_writes(tmp_path):
    """`save_checkpoint` of a small refiner after one Adam update (moments
    not zero), read back by the port bit for bit."""
    from megapose6d_tpu.training.config import TrainingConfig, make_refiner_cfg
    from megapose6d_tpu.training.train import save_checkpoint

    cfg = make_refiner_cfg(TrainingConfig(input_resize=(32, 48), render_size=(32, 48), backbone_str="resnet18",
                                          batch_size=2, epoch_size=2))
    state = jax_state(cfg=cfg, seed=3)
    state = state.apply_gradients(grads=jax.tree.map(lambda p: jnp.full_like(p, 0.01), state.params))
    save_checkpoint(tmp_path, state, epoch=3)
    got = read_checkpoint(tmp_path / "checkpoints/epoch_3")
    assert_same_arrays(array_leaves(got), flat_jax(restored_tree(state)))
    assert int(got["opt_state"][1][0]["count"]) == 1 and int(got["step"]) == 1


def test_hashes_json_is_tensorstores_and_the_ports():
    table = json.loads(hashes.HASHES.read_text())
    assert sum(map(len, table.values())) == 840
    assert table == json.loads(json.dumps(hashes.compute()))
    for name, arrays in table.items():
        got = array_leaves(read_checkpoint(ROOT / name))
        assert {k: hashes.entry(v) for k, v in got.items()} == arrays, name
        assert all(v.dtype.name in ("float32", "int32") for v in got.values())


def test_refuses_corrupt_stores(tmp_path):
    src = RUNS / "detector_long/checkpoints/final"
    ck = tmp_path / "final"
    shutil.copytree(src, ck)
    manifest = bytearray((ck / "manifest.ocdbt").read_bytes())
    manifest[20] ^= 1
    (ck / "manifest.ocdbt").write_bytes(bytes(manifest))
    with pytest.raises(ValueError, match="CRC"):
        read_checkpoint(ck)
    shutil.rmtree(ck)
    shutil.copytree(src, ck)
    store = OcdbtStore(ck)
    files = {store.value(k).file for k in store.list() if store.value(k).inline is None}
    (ck / sorted(files)[0]).unlink()
    with pytest.raises(FileNotFoundError):
        read_checkpoint(ck)


def test_refuses_what_it_does_not_read(tmp_path, monkeypatch):
    ck = RUNS / "detector_long/checkpoints/final"
    store = OcdbtStore(ck)
    name = "params.params.Conv_0.kernel"
    meta = json.loads(store.read(f"{name}/.zarray"))
    from megapose6d_tpu_torch.interop import orbax

    for change, match in (({"filters": [{"id": "delta"}]}, "filters"), ({"compressor": {"id": "blosc"}}, "compressor"),
                          ({"dtype": "|O"}, "dtype")):
        text = json.dumps({**meta, **change}).encode()
        monkeypatch.setattr(store, "read", lambda key, t=text, r=store.read: t if key.endswith(".zarray") else r(key))
        with pytest.raises(ValueError, match=match):
            orbax.read_array(store, name)
    monkeypatch.undo()
    bigger = json.dumps({**meta, "shape": [2 * meta["shape"][0], *meta["shape"][1:]]}).encode()
    monkeypatch.setattr(store, "read", lambda key, r=store.read: bigger if key.endswith(".zarray") else r(key))
    with pytest.raises(ValueError, match="chunk missing"):
        orbax.read_array(store, name)


def test_big_endian_and_chunk_grid(tmp_path):
    """A zarr v2 array in OCDBT as tensorstore writes it, big endian and
    over a 3 x 2 grid of chunks with partial edge chunks."""
    a = np.arange(7 * 5, dtype=">f4").reshape(7, 5) / 3
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}", "path": "x/"},
            "metadata": {"dtype": ">f4", "shape": [7, 5], "chunks": [3, 3], "compressor": {"id": "zstd", "level": 3},
                         "fill_value": None}, "create": True}
    ts.open(spec).result().write(a).result()
    from megapose6d_tpu_torch.interop import orbax

    got = orbax.read_array(OcdbtStore(tmp_path), "x")
    assert got.dtype == np.float32 and np.array_equal(got, a.astype(np.float32))
    assert hashlib.sha256(got.tobytes()).digest() == hashlib.sha256(a.astype("<f4").tobytes()).digest()
