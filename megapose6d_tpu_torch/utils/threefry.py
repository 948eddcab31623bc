"""The JAX package's random draws, reproduced in numpy.

The depth refiners choose their points from a uniform field drawn with
`jax.random.uniform(key, (H, W))`, from keys split off `PRNGKey(0)`. With
the same field the port samples the same pixels, so its poses can be held
to the JAX package's per instance; the demos draw their evaluation scenes
and pose noise as the JAX scripts do. This module computes `PRNGKey`,
`split`, `fold_in`, `uniform` (float32) and `randint` bit for bit, and `normal` to
the last bits, as JAX 0.9 does with
`jax_threefry_partitionable=True` (its default): the Threefry-2x32 hash
(20 rounds, key schedule `k0, k1, k0 ^ k1 ^ 0x1BD11BDA`) of a 64-bit
counter held as two 32-bit words, `(hi, lo)` = the flat index of each
output element; `fold_in` hashes the pair `(0, data)`. The draw is small (120x160 floats per object), so it runs
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


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for `data` in [0, 2**32): `uint32 [2]`."""
    if not 0 <= data < 2**32:
        raise ValueError("data must be in [0, 2**32)")
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return np.concatenate([b0, b1])


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element, `uint32 [shape]`."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counters(tuple(shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, minval=, maxval=)` in float32: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled to
    [minval, maxval) and held at or above minval."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(u, hi - lo, lo))


def _fma(a, b, c) -> np.ndarray:
    """`a * b + c` of float32 values rounded once, as XLA's fused
    multiply-add (the float64 product of two float32 values is exact)."""
    f64 = lambda x: np.asarray(x, np.float64)
    return (f64(a) * f64(b) + f64(c)).astype(np.float32)


def randint(key: np.ndarray, shape: tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval)` (int32, maxval
    below 2**31): two words of bits from the two halves of a split, each
    reduced modulo the span, combined as `hi * (2**16 mod span)**2 + lo`
    modulo the span, in uint32 arithmetic."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(maxval - minval, 1))
    mult = np.uint32(2**16) % span
    with np.errstate(over="ignore"):
        mult = (mult * mult) % span
        offset = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


# The inverse error function of XLA in float32 (Giles' approximation).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.normal(key, shape)` in float32: `sqrt(2) * erfinv(u)` for
    `u` uniform in (-1, 1). The inverse error function is XLA's polynomial
    evaluated in numpy float32; where XLA fuses its multiply-adds, values
    may differ from JAX's in the last bits."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    x = uniform(key, shape, lo, 1.0)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(small, np.float32(c_lt), np.float32(c_ge)))
    return (np.float32(np.sqrt(2.0)) * (p * x)).astype(np.float32)
