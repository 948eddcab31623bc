"""Read and write the JAX package's orbax checkpoints, with neither orbax
nor tensorstore.

A checkpoint directory (`<run>/checkpoints/epoch_<N>`, a detector run's
`final` or `step_<N>`), as orbax's `StandardCheckpointer` writes it, holds:
  - `_METADATA`: JSON whose `tree_metadata` gives each leaf's key tuple
    (`key_metadata`: each key with its type, 2 a mapping key, 1 a sequence
    index) and its value type; a "None" leaf stores nothing;
  - an OCDBT store (`utils/ocdbt.py`) of zarr v2 arrays, one per leaf,
    named by its keys joined with ".": `<name>/.zarray` (shape, chunks,
    dtype, compressor, order, fill value) and the chunks
    `<name>/<i>.<j>...` (`0` for a scalar), each a zstd frame
    (`native/zstd.cc`).

    read_checkpoint(path, prefixes=None) -> {"params": ..., "opt_state": ..., "step": ...}
    write_checkpoint(path, tree)
    array_leaves(tree) -> {"params.params.backbone.Conv_0.kernel": array, ...}
    is_orbax_checkpoint(path) -> bool
    top_level_keys(path) -> ["opt_state", "params", "step"]

`read_checkpoint` builds the tree from the key tuples: a dict under mapping
keys, a list under sequence indices (optax's tuples, so `opt_state[1][0]`
is Adam's `{"count", "mu", "nu"}`), numpy arrays at the leaves. It is the
tree the JAX package's `load_checkpoint` restores, equal bit for bit
(`tests/test_torch_orbax.py`), so `interop/from_jax.py` takes its
`params` as they are. `prefixes` keeps the leaves whose first key is one of
them; the data files of the others are not read. Arrays are read and
decoded in up to 8 threads. Refuses a checkpoint that
is not an OCDBT zarr v2 one, filters, compressors other than zstd and
chunks that are missing, with a message.

`write_checkpoint` is its inverse, and writes what orbax 0.11's
`StandardCheckpointer().save` writes for a tree of numpy arrays (held
against orbax's own save in `tests/test_torch_orbax_write.py`): the tree's
dicts (string keys, in sorted order) and lists or tuples, its leaves numpy
arrays ("np.ndarray") and Python bools, ints and floats ("scalar"; stored as
bool, int64 and float64), None and empty containers stored as nothing
("None", "Dict", "List", "Tuple"); each array one zarr v2 chunk in
little-endian C order, compressed by `native.encode_zstd` under orbax's
`{"id": "zstd", "level": 1}`, in an OCDBT store (`utils/ocdbt.write_ocdbt`)
beside `_METADATA` and `_CHECKPOINT_METADATA`. It writes into
`<path>.orbax-checkpoint-tmp` and renames that to `path` at the end, as
orbax finalizes a checkpoint; arrays of no elements are refused, as orbax
refuses them.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from pathlib import Path
from typing import Any, Iterable

import numpy as np

from .. import native
from ..utils.ocdbt import OcdbtStore, write_ocdbt

_SEQUENCE, _MAPPING = 1, 2  # orbax's KeyType.SEQUENCE and KeyType.DICT
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple}  # the value types of empty containers
_COMPRESSOR = {"id": "zstd", "level": 1}
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def is_orbax_checkpoint(path: str | Path) -> bool:
    """True for a directory orbax wrote (`_METADATA` beside an OCDBT manifest)."""
    path = Path(path)
    return (path / "_METADATA").is_file() and (path / "manifest.ocdbt").is_file()


def _leaves(path: Path) -> list[tuple[tuple[Any, ...], str | None, str]]:
    """(key tuple, array name or None for a leaf that stores nothing, value
    type) of each leaf."""
    meta = json.loads((path / "_METADATA").read_text())
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT checkpoints of zarr v2 arrays are read")
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = tuple(int(k["key"]) if k["key_type"] == _SEQUENCE else str(k["key"]) for k in entry["key_metadata"])
        value_type = entry["value_metadata"]["value_type"]
        stored = value_type != "None" and not entry["value_metadata"]["skip_deserialize"]
        leaves.append((keys, ".".join(str(k) for k in keys) if stored else None, value_type))
    return leaves


def top_level_keys(path: str | Path) -> list[str]:
    """The first keys of a checkpoint's leaves (`params`, `step`, ...), sorted."""
    return sorted({str(keys[0]) for keys, _, _ in _leaves(Path(path))})


def _assemble(leaves: Iterable[tuple[tuple[Any, ...], Any]]) -> Any:
    """The nested tree of (key tuple, value) pairs: dicts under mapping
    keys, lists (in index order) under sequence indices."""
    root: dict = {}
    for keys, value in leaves:
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"sequence indices {sorted(node)} are not 0..{len(node) - 1}")
            return [build(node[i]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def array_leaves(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """The arrays of a `read_checkpoint` tree by orbax's names (the keys
    joined with ".")."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out: dict[str, np.ndarray] = {}
        for k, v in items:
            out.update(array_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {} if tree is None else {prefix: tree}


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store`: its `.zarray` and chunks, each
    chunk zstd-decoded into place."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    compressor = meta.get("compressor") or {}
    if compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor or None} is not read, only zstd")
    dtype = np.dtype(meta["dtype"])
    if dtype.kind not in "biuf" or dtype.fields is not None:
        raise ValueError(f"{name}: dtype {meta['dtype']} is not read")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{name}: order {order!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype.newbyteorder("="))
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for index in product(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        try:
            data = store.read(key)
        except KeyError:
            raise ValueError(f"{key}: chunk missing (fill value {meta.get('fill_value')!r} is not filled in)") from None
        chunk = np.empty(math.prod(chunks), dtype)
        n = native.decode_zstd_into(data, chunk)
        if n != chunk.nbytes:
            raise ValueError(f"{key}: {n} bytes decoded, a chunk is {chunk.nbytes}")
        chunk = chunk.reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def read_checkpoint(path: str | Path, prefixes: Iterable[str] | None = None) -> dict[str, Any]:
    """The tree of an orbax checkpoint directory as nested dicts and lists
    of numpy arrays (None where the checkpoint stores None); with
    `prefixes`, only the leaves under those top-level keys."""
    path = Path(path)
    if not is_orbax_checkpoint(path):
        raise FileNotFoundError(f"{path} is not an orbax checkpoint (no _METADATA and manifest.ocdbt)")
    keep = None if prefixes is None else set(prefixes)
    leaves = [leaf for leaf in _leaves(path) if keep is None or leaf[0][0] in keep]
    if keep is not None and not keep <= {keys[0] for keys, _, _ in leaves}:
        raise KeyError(f"{path} has no {sorted(keep - {keys[0] for keys, _, _ in leaves})}")
    store = OcdbtStore(path)
    names = [name for _, name, _ in leaves if name is not None]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:  # the decoder releases the GIL
        arrays = dict(zip(names, pool.map(lambda name: read_array(store, name), names)))
    def value(name: str | None, kind: str) -> Any:
        if name is not None:
            return arrays[name]
        return _EMPTY[kind]() if kind in _EMPTY else None

    return _assemble((keys, value(name, kind)) for keys, name, kind in leaves)


def _flatten(tree: Any, keys: tuple = ()) -> list[tuple[tuple, tuple, Any]]:
    """(keys, key types, leaf) in the order orbax lists a tree: dict keys
    sorted, sequences by index; an empty container is a leaf."""
    if isinstance(tree, dict) and tree:
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"checkpoint dict keys must be strings, found {sorted(map(repr, tree))}")
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k], keys + ((k, _MAPPING),))]
    if isinstance(tree, (list, tuple)) and tree:
        return [leaf for i, v in enumerate(tree) for leaf in _flatten(v, keys + ((i, _SEQUENCE),))]
    return [(tuple(k for k, _ in keys), tuple(t for _, t in keys), tree)]


def _leaf_array(leaf: Any, name: str) -> tuple[str, np.ndarray | None]:
    """(orbax's value type, the array to store or None) of a leaf."""
    if leaf is None:
        return "None", None
    for kind, container in _EMPTY.items():
        if isinstance(leaf, container):
            return kind, None
    if isinstance(leaf, (np.ndarray, np.generic)):  # before float: np.float64 is one
        kind, array = "np.ndarray", np.asarray(leaf)
    elif isinstance(leaf, (bool, int, float)):
        kind, array = "scalar", np.asarray(leaf, np.bool_ if isinstance(leaf, bool) else
                                          np.int64 if isinstance(leaf, int) else np.float64)
    else:
        raise TypeError(f"{name}: a checkpoint leaf is a numpy array, bool, int, float or None, not "
                        f"{type(leaf).__name__}")
    if array.dtype.kind not in "biuf":
        raise TypeError(f"{name}: dtype {array.dtype} is not written")
    if array.size == 0:
        raise ValueError(f"{name}: cannot save arrays with zero size (orbax refuses them too)")
    return kind, np.asarray(array, array.dtype.newbyteorder("<"), order="C")  # 0-d stays 0-d


def write_checkpoint(path: str | Path, tree: Any) -> Path:
    """Write `tree` (nested dicts and lists of numpy arrays and scalars) as
    the orbax checkpoint directory `path`, which must not exist yet; returns
    `path`. `read_checkpoint`, orbax and tensorstore read it back."""
    path = Path(path)
    if path.exists():
        raise FileExistsError(f"{path} exists")
    started = time.time_ns()
    tree_meta, arrays = {}, {}
    for keys, types, leaf in _flatten(tree):
        name = ".".join(str(k) for k in keys)
        kind, array = _leaf_array(leaf, name)
        tree_meta[str(tuple(str(k) for k in keys))] = {
            "key_metadata": [{"key": str(k), "key_type": t} for k, t in zip(keys, types)],
            "value_metadata": {"value_type": kind, "skip_deserialize": array is None},
        }
        if array is not None:
            arrays[name] = array
    items = {}
    for name, array in arrays.items():
        shape = list(array.shape)
        items[f"{name}/.zarray"] = json.dumps(
            {"chunks": shape, "compressor": _COMPRESSOR, "dimension_separator": ".", "dtype": array.dtype.str,
             "fill_value": None, "filters": None, "order": "C", "shape": shape, "zarr_format": 2},
            sort_keys=True, separators=(",", ":")).encode()
    chunk_keys = [f"{name}/{'.'.join('0' for _ in a.shape) or '0'}" for name, a in arrays.items()]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:  # the encoder releases the GIL
        items.update(zip(chunk_keys, pool.map(native.encode_zstd, arrays.values())))
    tmp = path.with_name(path.name + ".orbax-checkpoint-tmp")
    if tmp.exists():
        shutil.rmtree(tmp)  # a write that did not finish
    write_ocdbt(tmp, items)
    (tmp / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": started,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}))
    tmp.rename(path)
    return path
