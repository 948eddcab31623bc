"""Resource probes: the card's memory and the host's resident set.

Counterpart of `megapose6d_tpu/utils/resources.py`: the device's figures
come from `torch.cuda.memory_stats` (what this process's caching
allocator holds) and `torch.cuda.mem_get_info` (the card's free and total
memory), the host's from `/proc/self/status`.
"""

from __future__ import annotations

import torch


def device_memory_stats(device: str | torch.device = "cuda") -> dict[str, int]:
    """`bytes_in_use` and `peak_bytes_in_use` (tensors this process has
    allocated on the card, now and at the peak), `bytes_reserved` (held by
    its caching allocator), `bytes_free` and `bytes_limit` (the card's free
    and total memory). Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats: no CUDA card")
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_free": int(free),
        "bytes_limit": int(total),
    }


def host_memory_rss_mb() -> float:
    """This process's resident set in MiB (`VmRSS`), 0 where `/proc` has
    none."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def assert_memory_below(fraction: float = 0.95, device: str | torch.device = "cuda") -> None:
    """Raise when the card's used memory (total - free) reaches `fraction`
    of its total."""
    s = device_memory_stats(device)
    used = 1.0 - s["bytes_free"] / s["bytes_limit"]
    if used >= fraction:
        raise AssertionError(f"device memory {used:.1%} >= {fraction:.0%}")
