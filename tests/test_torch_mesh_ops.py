"""Port vs JAX: `ops/mesh_ops.py`, exactly.

- `masked_bounds`, `get_meshes_center` and `get_meshes_bounding_boxes`
  with and without a padding mask: equal to the JAX package's.
- `sample_points` deterministic (the strided subset, with XLA's float32
  `linspace` arithmetic) at point counts where float64 truncation would
  pick other points, and random from JAX keys (the threefry uniform
  scores and top-k with ties to the lower index): the same points, key
  for key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.ops import mesh_ops as jm
from megapose6d_tpu_torch.ops import mesh_ops as tm


@pytest.mark.parametrize("masked", [False, True])
def test_bounds_center_corners(rng, masked):
    p = rng.normal(size=(3, 50, 3)).astype(np.float32)
    valid = rng.uniform(size=(3, 50)) > 0.3 if masked else None
    jv, tv = (None, None) if valid is None else (jnp.asarray(valid), torch.as_tensor(valid))
    for jf, tf in ((jm.get_meshes_center, tm.get_meshes_center),
                   (jm.get_meshes_bounding_boxes, tm.get_meshes_bounding_boxes)):
        np.testing.assert_array_equal(tf(torch.as_tensor(p), tv).numpy(), np.asarray(jf(jnp.asarray(p), jv)))
    for a, b in zip(tm.masked_bounds(torch.as_tensor(p), tv), jm.masked_bounds(jnp.asarray(p), jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tm.get_meshes_bounding_boxes(torch.as_tensor(p), tv).shape == (3, 8, 3)


@pytest.mark.parametrize("N,n", [(15, 199), (2000, 512), (1000, 256), (7, 1)])
def test_sample_points_deterministic(rng, N, n):
    p = rng.normal(size=(2, N, 3)).astype(np.float32)
    t = tm.sample_points(None, torch.as_tensor(p), n, deterministic=True).numpy()
    j = np.asarray(jax.jit(lambda x: jm.sample_points(None, x, n, deterministic=True))(jnp.asarray(p)))
    np.testing.assert_array_equal(t, j)
    if N == 15:  # numpy's float64 linspace picks other points here
        assert not np.array_equal(np.linspace(0, N - 1, n).astype(np.int32), tm._strided_index(N, n))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sample_points_random_key_for_key(rng, seed):
    p = rng.normal(size=(3, 300, 3)).astype(np.float32)
    p[:, 150:] = p[:, :150]  # repeated points: equal points, distinct indices
    key = jax.random.PRNGKey(seed)
    j = np.asarray(jm.sample_points(key, jnp.asarray(p), 64))
    t = tm.sample_points(np.asarray(key), torch.as_tensor(p), 64).numpy()
    np.testing.assert_array_equal(t, j)
    assert len({tuple(x) for x in t[0]}) > 32  # a sample, not one point repeated
