"""A device mesh in one process: an ordered list of `torch.device`s.

Counterpart of `megapose6d_tpu/parallel/mesh.py`. Sharded inference
(`PoseEstimator(device_mesh=...)`) splits the hypothesis axis over the
list, as the JAX package's `shard_map` splits it over a mesh axis; each
device holds a replica of the models and mesh databases. A device may
appear more than once (two shards on one card). Training's data
parallelism is one process per device instead (`parallel.distributed`),
the torch idiom.
"""

from __future__ import annotations

from typing import Sequence

import torch


def make_mesh(n_devices: int | None = None, device_type: str = "cuda") -> list[torch.device]:
    """The first `n_devices` devices of `device_type` (all by default):
    the visible cards for "cuda", the one CPU device for "cpu". Raises when
    fewer devices exist; never swaps one type for the other."""
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    elif device_type == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError(f"make_mesh: unknown device_type {device_type!r}")
    if not devices:
        raise ValueError("make_mesh: no CUDA card is visible; pass device_type='cpu' to build a CPU mesh")
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh: requested {n_devices} devices but only {len(devices)} available "
                f"({devices}). To place several shards on one device, pass a list that repeats it, "
                "such as [torch.device('cuda', 0)] * 2.")
        devices = devices[:n_devices]
    return devices


def batch_sharding(n_rows: int, n_shards: int) -> list[slice]:
    """The rows of a batch of `n_rows` that each of `n_shards` shards takes:
    equal contiguous parts, in order."""
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not split into {n_shards} equal shards")
    per = n_rows // n_shards
    return [slice(i * per, (i + 1) * per) for i in range(n_shards)]


def shard_batch(batch: torch.Tensor, mesh: Sequence[torch.device]) -> list[torch.Tensor]:
    """`batch` split along its first axis over the mesh, each part on its
    device."""
    return [batch[rows].to(dev) for rows, dev in zip(batch_sharding(batch.shape[0], len(mesh)), mesh)]
