"""Cluster smoke test: ranks, devices and one collective.

Counterpart of `megapose6d_tpu/scripts/test_distributed.py`: join the
process group the environment describes, print the rank, the world size
and the devices, all-reduce `arange(world)` (each rank contributes its
own entry) and check the sum against world * (world - 1) / 2.

    torchrun --nproc_per_node=N -m megapose6d_tpu_torch.scripts.test_distributed
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from ..parallel.distributed import comm_device, init_distributed_mode, local_device

logger = logging.getLogger(__name__)


def main() -> float:
    rank, world = init_distributed_mode()
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    device = local_device() if n_cards else torch.device("cpu")  # gloo on the CPU names it
    logger.info("process %d/%d; device %s; cards visible: %d; backend %s", rank, world, device, n_cards,
                dist.get_backend() if dist.is_initialized() else "none")
    x = torch.arange(world, dtype=torch.float32)
    mine = torch.zeros(world, dtype=torch.float32)
    mine[rank] = x[rank]
    if world > 1:
        mine = mine.to(comm_device())
        dist.all_reduce(mine)
    total = float(mine.sum())
    expected = world * (world - 1) / 2
    if total != expected:
        raise RuntimeError(f"all-reduce sum over {world} ranks: {total}, expected {expected}")
    logger.info("collective sum over %d ranks OK (%s)", world, total)
    return total


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
