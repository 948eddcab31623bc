"""Label-sharded mesh database: each rank holds only its objects.

Counterpart of `megapose6d_tpu/meshes/sharded_db.py`, after the
reference's `split_objects_across_gpus`
(`train_megapose.py:94-112`): the labels are split at random into
balanced shards, and each rank builds, renders and samples only its own
shard, on its own device, with LOCAL label indices; only the gradients
cross between ranks (`training.train.train_step(reduce_over=...)`).

The JAX package stacks the shards into one array whose label axis is
sharded over a device mesh. Here a shard is a `BatchedMeshes` of its own,
on the device of the rank that holds it; `build(..., shard_ids=[rank])`
loads only that rank's meshes, and forced pad targets
(`n_vertices_pad`, `n_faces_pad`) make shards built apart agree on
shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .mesh_db import BatchedMeshes, MeshDataBase, RigidObjectDataset


def split_labels(labels: Sequence[str], n_shards: int, seed: int = 0) -> list[list[str]]:
    """A random balanced split (a seeded permutation, `np.array_split`),
    each shard padded to the longest by repeating its last label; the same
    split as the JAX package's."""
    labels = list(labels)
    if len(labels) < n_shards:
        raise ValueError(f"split_labels: {len(labels)} labels cannot fill {n_shards} shards")
    perm = np.random.RandomState(seed).permutation(len(labels))
    parts = np.array_split(perm, n_shards)
    per = max(len(p) for p in parts)
    out = []
    for p in parts:
        shard = [labels[i] for i in p]
        shard += [shard[-1]] * (per - len(shard))
        out.append(shard)
    return out


def _pad_labels(db: BatchedMeshes, labels: list[str]) -> BatchedMeshes:
    """`db` with its last row repeated up to `len(labels)` rows."""
    reps = len(labels) - len(db.labels)
    if reps == 0:
        return db
    padded = db._map(lambda x: torch.cat([x, x[-1:].expand((reps,) + x.shape[1:])]))
    return dataclasses.replace(padded, labels=tuple(labels))


@dataclasses.dataclass
class ShardedMeshDB:
    """The shards built in this process, each on its device.

    Attributes:
      shard_labels: every shard's labels without the padding (what the
        sampler draws from).
      per_shard: labels per shard, padding included.
      shards: shard id -> its `BatchedMeshes` of `per_shard` labels.
      padded_labels: every shard's labels as its arrays hold them.
    """

    shard_labels: list[list[str]]
    per_shard: int
    shards: dict[int, BatchedMeshes]
    padded_labels: list[list[str]]

    @property
    def n_shards(self) -> int:
        return len(self.shard_labels)

    def local_index(self, shard_id: int, labels: Sequence[str]) -> np.ndarray:
        """Labels -> LOCAL indices within shard `shard_id` (a padded label
        maps to its last row, as in the JAX package)."""
        table = {l: i for i, l in enumerate(self.padded_labels[shard_id])}
        return np.asarray([table[l] for l in labels], np.int32)

    def local_shard(self, shard_id: int) -> BatchedMeshes:
        """The arrays of one shard built here."""
        if shard_id not in self.shards:
            raise KeyError(f"shard {shard_id} was not built in this process (built: {sorted(self.shards)})")
        return self.shards[shard_id]

    @classmethod
    def build(
        cls,
        object_ds: RigidObjectDataset,
        n_shards: int,
        device_mesh: Sequence[torch.device | str] | torch.device | str | None = None,
        seed: int = 0,
        shard_ids: Sequence[int] | None = None,
        n_vertices_pad: int | None = None,
        n_faces_pad: int | None = None,
        align: int = 128,
        **db_kw,
    ) -> "ShardedMeshDB":
        """Split `object_ds`'s labels into `n_shards` and build the shards
        `shard_ids` (all by default), shard i on `device_mesh[i]` (or all on
        `device_mesh`, "cuda" when None). Shards built in one call share their pad targets (the
        largest shard's, unless forced); shards built apart, one per rank,
        need `n_vertices_pad` and `n_faces_pad`."""
        shards = split_labels(object_ds.labels, n_shards, seed)
        build_ids = list(range(n_shards)) if shard_ids is None else list(shard_ids)
        if shard_ids is not None and len(build_ids) < n_shards and not (n_vertices_pad and n_faces_pad):
            raise ValueError("shards built apart need n_vertices_pad and n_faces_pad to agree on shapes")
        devices = "cuda" if device_mesh is None else device_mesh
        if isinstance(devices, (str, torch.device)):
            devices = [devices] * n_shards
        by_label = {o.label: o for o in object_ds.objects}
        dbs = {sid: MeshDataBase.from_object_ds(
            RigidObjectDataset([by_label[l] for l in dict.fromkeys(shards[sid])]), **db_kw) for sid in build_ids}
        targets = [db.pad_targets(align) for db in dbs.values()]
        V = n_vertices_pad or max(v for v, _ in targets)
        F = n_faces_pad or max(f for _, f in targets)
        built = {sid: _pad_labels(db.batched(align, V, F, device=devices[sid]), shards[sid]) for sid, db in dbs.items()}
        return cls(shards=built, padded_labels=shards, shard_labels=[list(dict.fromkeys(s)) for s in shards],
                   per_shard=len(shards[0]))


def sample_local_batch_indices(db: ShardedMeshDB, batch_per_shard: int, seed: int) -> np.ndarray:
    """`[n_shards, batch_per_shard]` LOCAL mesh indices, each shard's drawn
    from its unpadded labels (the JAX package's draws)."""
    rng = np.random.RandomState(seed)
    out = np.zeros((db.n_shards, batch_per_shard), np.int32)
    for sid in range(db.n_shards):
        out[sid] = rng.randint(0, len(db.shard_labels[sid]), size=batch_per_shard)
    return out
