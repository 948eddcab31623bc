"""Read the JAX package's orbax checkpoints, with neither orbax nor
tensorstore.

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
    array_leaves(tree) -> {"params.params.backbone.Conv_0.kernel": array, ...}
    is_orbax_checkpoint(path) -> bool

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
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from pathlib import Path
from typing import Any, Iterable

import numpy as np

from .. import native
from ..utils.ocdbt import OcdbtStore

_SEQUENCE = 1  # orbax's KeyType.SEQUENCE; 2 is KeyType.DICT


def is_orbax_checkpoint(path: str | Path) -> bool:
    """True for a directory orbax wrote (`_METADATA` beside an OCDBT manifest)."""
    path = Path(path)
    return (path / "_METADATA").is_file() and (path / "manifest.ocdbt").is_file()


def _leaves(path: Path) -> list[tuple[tuple[Any, ...], str | None]]:
    """(key tuple, array name or None for a "None" leaf) of each leaf."""
    meta = json.loads((path / "_METADATA").read_text())
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT checkpoints of zarr v2 arrays are read")
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = tuple(int(k["key"]) if k["key_type"] == _SEQUENCE else str(k["key"]) for k in entry["key_metadata"])
        stored = entry["value_metadata"]["value_type"] != "None" and not entry["value_metadata"]["skip_deserialize"]
        leaves.append((keys, ".".join(str(k) for k in keys) if stored else None))
    return leaves


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
    if isinstance(tree, (dict, list)):
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
    leaves = [(keys, name) for keys, name in _leaves(path) if keep is None or keys[0] in keep]
    if keep is not None and not keep <= {keys[0] for keys, _ in leaves}:
        raise KeyError(f"{path} has no {sorted(keep - {keys[0] for keys, _ in leaves})}")
    store = OcdbtStore(path)
    names = [name for _, name in leaves if name is not None]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:  # the decoder releases the GIL
        arrays = dict(zip(names, pool.map(lambda name: read_array(store, name), names)))
    return _assemble((keys, None if name is None else arrays[name]) for keys, name in leaves)
