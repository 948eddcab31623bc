"""Process groups and collectives on `torch.distributed`.

Counterpart of `megapose6d_tpu/parallel/distributed.py`. One process per
device, as torchrun starts them:
  - `init_distributed_mode` reads torchrun's `RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT` (the variables the
    reference MegaPose reads), or the JAX package's `COORDINATOR_ADDRESS`
    (host:port) with `RANK` and `WORLD_SIZE`, and joins the group; with
    none of them set it runs as one process, with no group.
  - The backend is NCCL on the card, gloo on the CPU. NCCL refuses two
    ranks on one card, so where a node starts more ranks than it has
    cards (`LOCAL_WORLD_SIZE` > the device count) the ranks share the
    cards over gloo, whose all-reduce takes CUDA tensors.
  - `reduce_dict` all-reduces a metrics dict (mean or sum);
    `gather_collections` gathers per-rank prediction collections to rank
    0: tensors padded to the largest rank's rows, infos as JSON bytes.
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..data.tensor_collection import TensorCollection, concatenate

TIMEOUT = datetime.timedelta(minutes=10)


def _rendezvous() -> tuple[str, int, int] | None:
    """(init address, rank, world size) from the environment, or None for
    one process."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    if os.environ.get("COORDINATOR_ADDRESS"):
        host, port = os.environ["COORDINATOR_ADDRESS"].rsplit(":", 1)
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    elif world == 1:
        return None
    else:
        raise ValueError("WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT, or COORDINATOR_ADDRESS")
    return f"tcp://{host}:{port}", int(os.environ["RANK"]), world


def local_device() -> torch.device:
    """This rank's card, `cuda:LOCAL_RANK % device_count`. Raises when no
    CUDA card is visible: a rank never carries on on the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("local_device: no CUDA card is visible to this rank (torch.cuda.is_available() is "
                           "False); run on the CPU by passing device=cpu explicitly")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def init_distributed_mode() -> tuple[int, int]:
    """Join the process group the environment describes (once); returns
    (rank, world size), (0, 1) for one process."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    spec = _rendezvous()
    if spec is None:
        return 0, 1
    init_method, rank, world = spec
    backend = "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device())
        if int(os.environ.get("LOCAL_WORLD_SIZE", world)) <= torch.cuda.device_count():
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, timeout=TIMEOUT)
    return rank, world


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def comm_device() -> torch.device:
    """Where the backend takes every collective's tensors: the rank's card
    under NCCL, else the CPU."""
    return local_device() if dist.get_backend() == "nccl" else torch.device("cpu")


def reduce_dict(metrics: dict[str, float], average: bool = True, group=None) -> dict[str, float]:
    """A metrics dict all-reduced over the ranks of `group` (all by
    default): the mean of each value, or the sum."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float32, device=comm_device())
    dist.all_reduce(vec, group=group)
    if average:
        vec /= world
    return {k: float(v) for k, v in zip(keys, vec.cpu())}


def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(get_world_size())]
    dist.all_gather(parts, t)
    return parts


def _infos_to_bytes(infos: dict[str, np.ndarray]) -> bytes:
    cols = {k: [v.item() if isinstance(v, np.generic) else v for v in col.tolist()] for k, col in infos.items()}
    dtypes = {k: col.dtype.str if col.dtype != object else "O" for k, col in infos.items()}
    return json.dumps({"columns": cols, "dtypes": dtypes}).encode()


def _infos_from_bytes(data: bytes) -> dict[str, np.ndarray]:
    d = json.loads(data.decode())
    return {k: np.asarray(v, dtype=object if d["dtypes"][k] == "O" else np.dtype(d["dtypes"][k]))
            for k, v in d["columns"].items()}


def gather_collections(tc: TensorCollection) -> TensorCollection | None:
    """Every rank's collection gathered to rank 0, concatenated in rank
    order (ranks without rows skipped); None on the other ranks. Each
    tensor is padded to the largest rank's rows and all-gathered; the
    infos go as JSON bytes, padded to the largest payload."""
    if get_world_size() == 1:
        return tc
    dev = comm_device()
    counts = [int(c) for c in _all_gather(torch.tensor([len(tc)], device=dev))]
    n_max = max(counts)
    parts = {}
    for name, t in tc.tensors.items():
        pad = torch.zeros((n_max - len(t),) + t.shape[1:], dtype=t.dtype, device=dev)
        parts[name] = _all_gather(torch.cat([t.to(dev), pad]))
    payload = _infos_to_bytes(tc.infos)
    sizes = [int(s) for s in _all_gather(torch.tensor([len(payload)], device=dev))]
    buf = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
    infos_all = _all_gather(buf)
    if get_rank() != 0:
        return None
    out = []
    for r, n in enumerate(counts):
        if n == 0:
            continue
        infos = _infos_from_bytes(bytes(infos_all[r][: sizes[r]].cpu().numpy()))
        out.append(TensorCollection(infos=infos, **{k: v[r][:n].to(tc.tensors[k].device)
                                                    for k, v in parts.items()}))
    return concatenate(out)
