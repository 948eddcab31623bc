"""Port vs JAX: the pose losses of `ops/losses.py`.

Random poses, points and 9D refiner outputs from a numpy seed go through
each of the five functions in both packages, in float32, with the
symmetry and point masks (`sym_valid`, `points_valid`) on and off.
Tolerance: atol 1e-6 (the losses are means of centimetre-scale point
distances, so 1e-6 is a few float32 ulps of their size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.ops import losses as jl
from megapose6d_tpu_torch.ops import losses as tl

ATOL = 1e-6


def rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)


def poses(rng, n, z=0.5):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = rot(rng, n)
    T[:, :3, 3] = rng.normal(scale=0.02, size=(n, 3)) + [0, 0, z]
    return T.astype(np.float32)


def inputs(rng, B=4, S=3, N=50):
    TCO_gt = poses(rng, B)
    sym = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    sym[:, 1:, :3, :3] = rot(rng, B * (S - 1)).reshape(B, S - 1, 3, 3)
    TCO_possible_gt = (TCO_gt[:, None] @ sym).astype(np.float32)
    sym_valid = np.ones((B, S), bool)
    sym_valid[0, 2] = sym_valid[2, 1:] = False
    points_valid = rng.uniform(size=(B, N)) > 0.3
    points = rng.normal(scale=0.03, size=(B, N, 3)).astype(np.float32)
    TCO_in = poses(rng, B)
    out9 = np.concatenate([rng.normal(size=(B, 6)), rng.normal(scale=5, size=(B, 2)),
                           rng.uniform(0.8, 1.2, size=(B, 1))], -1).astype(np.float32)
    K = np.tile(np.asarray([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32), (B, 1, 1))
    return dict(TCO_gt=TCO_gt, TCO_possible_gt=TCO_possible_gt, sym_valid=sym_valid,
                points_valid=points_valid, points=points, TCO_in=TCO_in, out9=out9, K=K,
                tCR=TCO_in[:, :3, 3].copy())


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL, rtol=0)


MASKS = [pytest.param(False, id="unmasked"), pytest.param(True, id="masked")]


@pytest.mark.parametrize("masked", MASKS)
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_loss_CO_symmetric(rng, masked, norm):
    d = inputs(rng)
    kw_j = dict(sym_valid=jnp.asarray(d["sym_valid"]), points_valid=jnp.asarray(d["points_valid"])) if masked else {}
    kw_t = dict(sym_valid=torch.as_tensor(d["sym_valid"]),
                points_valid=torch.as_tensor(d["points_valid"])) if masked else {}
    TCO_pred = d["TCO_in"]
    lj, aj = jl.loss_CO_symmetric(jnp.asarray(d["TCO_possible_gt"]), jnp.asarray(TCO_pred),
                                  jnp.asarray(d["points"]), getattr(jl, norm), **kw_j)
    lt, at = tl.loss_CO_symmetric(torch.as_tensor(d["TCO_possible_gt"]), torch.as_tensor(TCO_pred),
                                  torch.as_tensor(d["points"]), getattr(tl, norm), **kw_t)
    close(lj, lt)
    close(aj, at)


@pytest.mark.parametrize("masked", MASKS)
def test_loss_refiner_disentangled(rng, masked):
    d = inputs(rng)
    names = ("TCO_possible_gt", "TCO_in", "out9", "K", "points", "tCR")
    kw = dict(sym_valid=d["sym_valid"], points_valid=d["points_valid"]) if masked else {}
    lj, dj = jl.loss_refiner_CO_disentangled_reference_point(
        *(jnp.asarray(d[n]) for n in names), **{k: jnp.asarray(v) for k, v in kw.items()})
    lt, dt = tl.loss_refiner_CO_disentangled_reference_point(
        *(torch.as_tensor(d[n]) for n in names), **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert set(dj) == set(dt)
    close(lj, lt)
    for k in dj:
        close(dj[k], dt[k])
    assert float(lt.min()) > 1e-4  # the loss is not trivially zero


@pytest.mark.parametrize("fn", ["dists_add", "dists_add_symmetric", "compute_ADD_L1_loss"])
def test_add_distances(rng, fn):
    d = inputs(rng)
    args = (d["TCO_in"], d["TCO_gt"], d["points"])
    close(getattr(jl, fn)(*(jnp.asarray(a) for a in args)), getattr(tl, fn)(*(torch.as_tensor(a) for a in args)))
