"""The port's orbax writer (`interop/orbax.write_checkpoint` over
`utils/ocdbt.write_ocdbt` and `native.encode_zstd`) and `slim_run_dir` on
the JAX package's runs, against orbax, tensorstore and the JAX package.

  - trees of f32 / f64 / i32 / i64 / u8 / f16 / bool arrays, numpy and
    Python scalars, None, empty containers and arrays over 128 KiB, and one
    of 300 arrays under a node limit that needs interior b-tree nodes: each
    written by `write_checkpoint`, then read by tensorstore's OCDBT kvstore
    and zarr driver, `orbax.checkpoint.PyTreeCheckpointer().restore` and
    the port's `read_checkpoint`, all equal bit for bit to what orbax reads
    from its own save of the tree; `_METADATA`'s tree and `.zarray`s as
    orbax writes them; arrays of no elements refused, as orbax refuses them;
  - the JAX package's `training.train.load_checkpoint` (params and step,
    and `params_only=True`) of a checkpoint the port writes;
  - OCDBT stores of up to 1000 keys under node limits of 200 bytes to
    100 MB: tensorstore lists and reads every key and writes on top of
    them; a one-leaf store laid out as tensorstore's (inline up to 1024
    bytes, indirect values in key order in one data file), and trees of
    up to 300 keys under limits of 150-2000 bytes with tensorstore's
    nodes, level by level;
  - the slim oracle: copies of `runs/refiner_dr` at `epoch_27000` (params,
    Adam's state, step) and of `runs/detector_long` (`step_12000` and
    `final`), slimmed by the JAX package's `slim_run_dir` and by the
    port's: the same directories remain, both restore bit for bit alike
    through orbax, the JAX package's `load_checkpoint` and the port, and
    the port's checkpoint is at most 1.02 times the JAX one's bytes.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ts = pytest.importorskip("tensorstore")
ocp = pytest.importorskip("orbax.checkpoint")

from megapose6d_tpu_torch.interop.orbax import array_leaves, read_checkpoint, write_checkpoint  # noqa: E402
from megapose6d_tpu_torch.scripts import slim_run_dir  # noqa: E402
from megapose6d_tpu_torch.utils import ocdbt  # noqa: E402
from megapose6d_tpu_torch.utils.ocdbt import OcdbtStore, write_ocdbt  # noqa: E402
from tests.test_torch_orbax import flat_jax, jax_state, kvstore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RUNS = ROOT / "runs"


def mixed_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "conv": {"kernel": rng.normal(size=(3, 3, 16, 32)).astype(np.float32), "bias": np.zeros(32, np.float32)},
            "dense": rng.normal(size=(200, 300)).astype(np.float32),  # 234 KiB: two zstd blocks
            "f64": rng.normal(size=(5, 7)),
            "i32": rng.integers(-5, 5, (4, 4), dtype=np.int32),
            "i64": rng.integers(0, 1 << 40, (3,), dtype=np.int64),
            "u8": rng.integers(0, 256, (9, 3), dtype=np.uint8),
            "f16": rng.normal(size=(6,)).astype(np.float16),
            "mask": rng.integers(0, 2, (5,)).astype(bool),
        },
        "opt_state": [None, {"count": np.int32(3), "mu": {"w": np.ones((2, 2), np.float32)}}, (np.int64(4),)],
        "step": np.asarray(27000, np.int32),
        "scalars": {"i": 5, "f": 2.5, "b": True, "np_f64": np.float64(1.25)},
        "empty": {"d": {}, "l": [], "t": (), "n": None},
    }


def many_keys_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {f"block_{i:03d}": {"kernel": rng.normal(size=(i % 7 + 1, 3)).astype(np.float32)}
                       for i in range(300)}, "step": np.int64(1)}


def orbax_save(path: Path, tree) -> Path:
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path.absolute(), tree)
    ckptr.wait_until_finished()
    return path


def orbax_restore(path: Path):
    return ocp.PyTreeCheckpointer().restore(str(path.absolute()))


def assert_same(a, b, where: str = ""):
    """The same tree: container types, leaf types, dtypes, shapes and bytes."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}.{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


def tensorstore_arrays(path: Path) -> dict[str, np.ndarray]:
    """Every array of a checkpoint through tensorstore's zarr driver, at its
    `.zarray` shape."""
    kv = kvstore(path)
    out = {}
    for key in kv.list().result():
        if key.endswith(b"/.zarray"):
            name = key[: -len(b"/.zarray")].decode()
            shape = json.loads(kv.read(key).result().value)["shape"]
            spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path.absolute()}",
                                                  "path": f"{name}/"}}
            out[name] = ts.open(spec, read=True).result().read().result().reshape(shape)
    return out


def metadata(path: Path) -> dict:
    meta = json.loads((path / "_METADATA").read_text())
    zarrays = {k: v for k, v in ((k, kvstore(path).read(k).result().value) for k in kvstore(path).list().result())
               if k.endswith(b".zarray")}
    return {"meta": meta, "tree_order": list(meta["tree_metadata"]), "zarrays": zarrays}


@pytest.mark.parametrize("which,node_bytes", [("mixed", 100_000_000), ("many_keys", 1500)])
def test_write_checkpoint_reads_back_everywhere(tmp_path, monkeypatch, which, node_bytes):
    """At orbax's node limit a checkpoint is one leaf; the store writer is
    given a small one for the tree of 300 arrays, to need interior nodes."""
    tree = mixed_tree(1) if which == "mixed" else many_keys_tree(2)
    monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", node_bytes)
    ours = write_checkpoint(tmp_path / "ours", tree)
    theirs = orbax_save(tmp_path / "theirs", tree)
    assert not (tmp_path / "ours.orbax-checkpoint-tmp").exists()
    assert metadata(ours) == metadata(theirs)
    height = OcdbtStore(ours).version.root_height
    assert height == 0 if which == "mixed" else height >= 2, height
    want = orbax_restore(theirs)
    assert_same(orbax_restore(ours), want)
    got_ts, want_ts = tensorstore_arrays(ours), tensorstore_arrays(theirs)
    assert got_ts.keys() == want_ts.keys()
    for k in want_ts:
        assert got_ts[k].dtype == want_ts[k].dtype and got_ts[k].tobytes() == want_ts[k].tobytes(), k
    port = read_checkpoint(ours)
    assert_same(port, read_checkpoint(theirs))
    leaves = array_leaves(port)
    assert leaves.keys() == want_ts.keys()
    for k in want_ts:
        assert leaves[k].dtype == want_ts[k].dtype and leaves[k].tobytes() == want_ts[k].tobytes(), k
    with pytest.raises(FileExistsError):
        write_checkpoint(ours, tree)


def test_write_checkpoint_refuses_what_orbax_refuses(tmp_path):
    with pytest.raises(ValueError, match="zero size"):
        orbax_save(tmp_path / "theirs", {"a": np.zeros((0, 3), np.float32)})
    with pytest.raises(ValueError, match="zero size"):
        write_checkpoint(tmp_path / "ours", {"a": np.zeros((0, 3), np.float32)})
    with pytest.raises(TypeError):
        write_checkpoint(tmp_path / "ours", {"a": "text"})
    assert not (tmp_path / "ours").exists()


def test_jax_load_checkpoint_of_a_port_checkpoint(tmp_path):
    """A small refiner after one Adam update, its params and step written by
    the port: the JAX package's `load_checkpoint` restores them (through
    its params-and-step fallback, and with `params_only=True`)."""
    from megapose6d_tpu.training.config import TrainingConfig, make_refiner_cfg
    from megapose6d_tpu.training.train import load_checkpoint

    cfg = make_refiner_cfg(TrainingConfig(input_resize=(32, 48), render_size=(32, 48), backbone_str="resnet18",
                                          batch_size=2, epoch_size=2))
    state = jax_state(cfg=cfg, seed=3)
    state = state.apply_gradients(grads=jax.tree.map(lambda p: jnp.full_like(p, 0.01), state.params))
    tree = {"params": jax.tree.map(np.asarray, state.params), "step": np.asarray(state.step)}
    write_checkpoint(tmp_path / "checkpoints/epoch_3", tree)
    (tmp_path / "checkpoints/latest.txt").write_text("3")
    fresh = jax_state(cfg=cfg, seed=5)
    restored, epoch = load_checkpoint(tmp_path, fresh)
    assert epoch == 3 and int(restored.step) == 1
    want = flat_jax({"params": state.params})
    for params in (restored.params, load_checkpoint(tmp_path, fresh, params_only=True)[0].params):
        got = flat_jax({"params": params})
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("n,node_bytes", [(1, 100_000_000), (40, 100_000_000), (300, 600), (1000, 2000), (120, 200)])
def test_ocdbt_stores_tensorstore_reads(tmp_path, monkeypatch, n, node_bytes):
    rng = np.random.default_rng(n)
    items = {}
    for i in range(n):
        key = f"params.layer_{i:04d}.{'kernel' if i % 3 else 'bias'}/{'0.0' if i % 2 else '.zarray'}"
        items[key] = rng.integers(0, 256, int(rng.choice([0, 7, 300, 1024, 1025, 5000])), dtype=np.uint8).tobytes()
    monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", node_bytes)
    write_ocdbt(tmp_path / "s", items)
    kv = kvstore(tmp_path / "s")
    assert {k.decode(): kv.read(k).result().value for k in kv.list().result()} == items
    store = OcdbtStore(tmp_path / "s")
    assert store.list() == sorted(items) and all(store.read(k) == v for k, v in items.items())
    assert (store.version.root_height > 0) == (n > 40)
    kv["zz/added"] = b"by tensorstore"
    assert kv.read(b"zz/added").result().value == b"by tensorstore"
    assert kv.read(sorted(items)[-1]).result().value == items[sorted(items)[-1]]


def test_ocdbt_one_node_layout_as_tensorstore(tmp_path):
    """One commit of tensorstore under orbax's config against the port's
    store: the same leaf (keys, value lengths, which are inline), indirect
    values in key order at the same offsets of one data file (tensorstore
    is asked again while it splits the transaction into several commits,
    as in `test_ocdbt_tree_layout_as_tensorstore`)."""
    rng = np.random.default_rng(4)
    items = {f"k{i:02d}": rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for i, s in enumerate([0, 1, 1023, 1024, 1025, 3000, 40, 70_000])}
    cfg = {"max_inline_value_bytes": 1024, "max_decoded_node_bytes": 100_000_000, "version_tree_arity_log2": 4,
           "compression": {"id": "zstd"}}
    for attempt in range(5):
        kv = kvstore(tmp_path / f"ts{attempt}", config=cfg)
        with ts.Transaction() as txn:
            for k, v in items.items():
                kv.with_transaction(txn)[k] = v
        if OcdbtStore(tmp_path / f"ts{attempt}").version.generation == 2:  # the empty store, then one commit
            break
    else:
        pytest.fail("tensorstore split the transaction into several commits five times")
    write_ocdbt(tmp_path / "port", items)
    names = (f"ts{attempt}", "port")
    stores = [OcdbtStore(tmp_path / name) for name in names]
    for store in stores:
        assert store.version.root_height == 0 and store.version.num_keys == len(items)
    layout = [[(k, s.value(k).inline is None, s.value(k).offset) for k in s.list()] for s in stores]
    assert layout[0] == layout[1]
    assert [len(list((tmp_path / name / "d").iterdir())) for name in names] == [1, 1]


def tree_nodes(root: Path) -> list[tuple[int, list[bytes]]]:
    """(height, full keys) of every b-tree node of the newest version, in
    depth-first order."""
    store = OcdbtStore(root)
    out = []

    def walk(ref, height: int, prefix: bytes) -> None:
        body = ocdbt.decode_envelope(store._slice(ref), ocdbt.BTREE_NODE_MAGIC, "node", store.max_node_bytes)
        r = ocdbt._Reader(body, "node")
        assert r.u8() == height
        paths, bases = ocdbt._data_file_table(r, ref.base)
        n = r.varint()
        keys, common = ocdbt._keys(r, n, interior=height > 0)
        out.append((height, [prefix + k for k in keys]))
        if height:
            fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                walk(ocdbt._node_ref(paths, bases, fids[i], offsets[i], lengths[i], "node"), height - 1,
                     prefix + keys[i][: common[i]])

    walk(store.version.root, store.version.root_height, b"")
    return out


@pytest.mark.parametrize("seed,n,node_bytes", [(0, 100, 1000), (1, 101, 500), (2, 60, 600), (3, 250, 300),
                                               (4, 87, 150), (5, 300, 2000), (6, 120, 800)])
def test_ocdbt_tree_layout_as_tensorstore(tmp_path, monkeypatch, seed, n, node_bytes):
    """Orbax-like keys, inline values of 0-1024 bytes and some in the data
    file: the port's b-tree has tensorstore's nodes, level by level (its
    one-commit layout: tensorstore is asked again while it splits the
    transaction into several commits)."""
    rng = np.random.default_rng(seed)
    words = ["params", "opt_state", "mu", "backbone", "Conv_0", "kernel", "bias", "BasicBlock_1", "GroupNorm_0"]
    keys = set()
    while len(keys) < n:
        name = ".".join(rng.choice(words, int(rng.integers(1, 5))))
        keys.add(f"{name}_{int(rng.integers(0, 50))}/{rng.choice(['.zarray', '0', '0.0', '0.0.0.0'])}")
    items = {k: rng.integers(0, 256, int(rng.choice([0, 3, 40, 200, 1024, 1025])), dtype=np.uint8).tobytes()
             for k in sorted(keys)}
    cfg = {"max_inline_value_bytes": 1024, "max_decoded_node_bytes": node_bytes, "version_tree_arity_log2": 4,
           "compression": {"id": "zstd"}}
    for attempt in range(5):
        kv = kvstore(tmp_path / f"ts{attempt}", config=cfg)
        with ts.Transaction() as txn:
            for k, v in items.items():
                kv.with_transaction(txn)[k] = v
        if OcdbtStore(tmp_path / f"ts{attempt}").version.generation == 2:  # the empty store, then one commit
            break
    else:
        pytest.fail("tensorstore split the transaction into several commits five times")
    monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", node_bytes)
    write_ocdbt(tmp_path / "port", items)
    want, got = tree_nodes(tmp_path / f"ts{attempt}"), tree_nodes(tmp_path / "port")
    assert max(h for h, _ in want) > 0
    assert got == want


def copy_run(src: Path, dst: Path, keep: list[str], latest: str) -> Path:
    (dst / "checkpoints").mkdir(parents=True)
    for name in keep:
        shutil.copytree(src / "checkpoints" / name, dst / "checkpoints" / name)
    (dst / "checkpoints/latest.txt").write_text(latest)
    shutil.copy(src / "config.json", dst / "config.json")
    return dst


def disk_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


@pytest.mark.parametrize("run,keep,latest,kept", [
    ("refiner_dr", ["epoch_27000"], "27000", "epoch_27000"),
    ("detector_long", ["step_12000", "final"], "12000", "step_12000"),
])
def test_slim_run_dir_as_the_jax_package(tmp_path, run, keep, latest, kept):
    from megapose6d_tpu.scripts.slim_run_dir import slim_run_dir as jax_slim

    src = RUNS / run
    full = read_checkpoint(src / "checkpoints" / kept)
    jax_run = copy_run(src, tmp_path / "jax", keep, latest)
    port_run = copy_run(src, tmp_path / "port", keep, latest)
    jax_slim(jax_run)
    assert slim_run_dir.slim_run_dir(port_run) == port_run / "checkpoints" / kept
    names = sorted(p.name for p in (port_run / "checkpoints").iterdir())
    assert names == sorted(p.name for p in (jax_run / "checkpoints").iterdir()) == sorted(keep + ["latest.txt"])
    a, b = jax_run / "checkpoints" / kept, port_run / "checkpoints" / kept
    assert json.loads((a / "_METADATA").read_text()) == json.loads((b / "_METADATA").read_text())
    assert_same(orbax_restore(b), orbax_restore(a))
    port = read_checkpoint(b)
    assert_same(port, read_checkpoint(a))
    assert_same(port, {k: full[k] for k in ("params", "step") if k in full})
    assert set(port) == ({"params", "step"} if run == "refiner_dr" else {"params"})
    assert disk_bytes(b) <= 1.02 * disk_bytes(a), (disk_bytes(b), disk_bytes(a))
    if run == "refiner_dr":
        from megapose6d_tpu.training.train import load_checkpoint

        state = jax_state(run)
        for params_only in (False, True):
            want, _ = load_checkpoint(jax_run, state, params_only=params_only)
            got, epoch = load_checkpoint(port_run, state, params_only=params_only)
            assert epoch == 27000 and int(got.step) == (int(state.step) if params_only else 27000)
            w, g = flat_jax(want.params), flat_jax(got.params)
            assert w.keys() == g.keys() and all(w[k].tobytes() == g[k].tobytes() for k in w)
