"""Seeding helpers.

Counterpart of `megapose6d_tpu/utils/random.py`: `seed_everything` seeds
Python's `random`, numpy's global generator and, here, torch's (CPU and
every card).
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch


def get_unique_seed() -> int:
    """A seed from the process id, the clock and the OS's entropy."""
    return (os.getpid() ^ int(time.time() * 1e6) ^ int.from_bytes(os.urandom(4), "little")) % (2**31)


def seed_everything(seed: int | None = None) -> int:
    """Seed `random`, `np.random` and torch with `seed` (a unique one when
    None); returns the seed."""
    seed = get_unique_seed() if seed is None else seed
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed
