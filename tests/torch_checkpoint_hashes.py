"""`tests/data/torch_checkpoints/hashes.json`: every array of the committed
orbax checkpoints (`runs/*/checkpoints/*/`), read through tensorstore (its
zarr driver over the checkpoint's OCDBT store, as orbax restores them),
with its dtype, shape and the SHA-256 of its bytes (C order, little
endian): `{checkpoint: {array: [dtype, shape, sha256]}}`. `chip_smoke.py` phase 23 holds the port's reads against it on the
card's machine, which has neither orbax nor tensorstore;
`tests/test_torch_orbax.py` holds the file against tensorstore here.

    python -m tests.torch_checkpoint_hashes        # rewrites hashes.json (~10 s)
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HASHES = ROOT / "tests/data/torch_checkpoints/hashes.json"


def checkpoint_dirs() -> list[Path]:
    """The committed orbax checkpoint directories, sorted."""
    return sorted(p.parent for p in (ROOT / "runs").glob("*/checkpoints/*/manifest.ocdbt"))


def array_names(path: Path) -> list[str]:
    """The stored arrays of a checkpoint: its leaves' keys joined by "."."""
    meta = json.loads((path / "_METADATA").read_text())["tree_metadata"]
    return sorted(".".join(k["key"] for k in e["key_metadata"]) for e in meta.values()
                  if e["value_metadata"]["value_type"] != "None")


def tensorstore_array(path: Path, name: str) -> np.ndarray:
    """The array `name`, at the shape of its `.zarray` (tensorstore's zarr
    driver gives a zarr scalar, shape `[]`, as shape `[1]`)."""
    import tensorstore as ts

    kv = {"driver": "ocdbt", "base": f"file://{path.absolute()}"}
    shape = json.loads(ts.KvStore.open(kv).result().read(f"{name}/.zarray").result().value)["shape"]
    a = ts.open({"driver": "zarr", "kvstore": {**kv, "path": f"{name}/"}}, read=True).result().read().result()
    return a.reshape(shape)


def entry(a: np.ndarray) -> list:
    """[dtype, shape, SHA-256 of the little-endian C-order bytes]."""
    a = a.astype(a.dtype.newbyteorder("<"), order="C")
    return [a.dtype.name, list(a.shape), hashlib.sha256(a.tobytes()).hexdigest()]


def dumps(table: dict) -> str:
    """The table as JSON, one array a line."""
    ckpts = []
    for ck, arrays in table.items():
        lines = ",\n".join(f"  {json.dumps(n)}: {json.dumps(e)}" for n, e in arrays.items())
        ckpts.append(f" {json.dumps(ck)}: {{\n{lines}\n }}")
    return "{\n" + ",\n".join(ckpts) + "\n}\n"


def compute() -> dict:
    return {str(p.relative_to(ROOT)): {n: entry(tensorstore_array(p, n)) for n in array_names(p)}
            for p in checkpoint_dirs()}


if __name__ == "__main__":
    HASHES.parent.mkdir(parents=True, exist_ok=True)
    table = compute()
    HASHES.write_text(dumps(table))
    print(f"{HASHES}: {sum(map(len, table.values()))} arrays of {len(table)} checkpoints")
