"""The JAX package's random draws, reproduced in numpy.

The depth refiners choose their points from a uniform field drawn with
`jax.random.uniform(key, (H, W))`, from keys split off `PRNGKey(0)`. With
the same field the port samples the same pixels, so its poses can be held
to the JAX package's per instance. This module computes `PRNGKey`,
`split` and `uniform` (float32) bit for bit as JAX 0.9 does with
`jax_threefry_partitionable=True` (its default): the Threefry-2x32 hash
(20 rounds, key schedule `k0, k1, k0 ^ k1 ^ 0x1BD11BDA`) of a 64-bit
counter held as two 32-bit words, `(hi, lo)` = the flat index of each
output element. The draw is small (120x160 floats per object), so it runs
on the host; callers copy the field to their device.

Keys are `uint32 [2]` arrays, as JAX's raw keys.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter words `(x0, x1)` (uint32 arrays
    of one shape) under `key` (uint32 [2])."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    n = int(np.prod(shape, dtype=np.int64))
    if n > 2**32:
        raise ValueError("more than 2**32 draws")
    lo = np.arange(n, dtype=np.uint64)
    return (lo >> np.uint64(32)).astype(np.uint32).reshape(shape), lo.astype(np.uint32).reshape(shape)


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2**32)."""
    if not 0 <= seed < 2**32:
        raise ValueError("seed must be in [0, 2**32)")
    return np.array([0, seed], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: `uint32 [num, 2]`."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counters((num,)))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element, `uint32 [shape]`."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counters(tuple(shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.uniform(key, shape)` in float32, in [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
