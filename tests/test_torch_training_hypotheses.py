"""Port vs JAX: the training hypotheses of `make_hypotheses`, and the
port's own draws.

Each of the four methods runs in both packages on one batch. The JAX
function draws from its key; the port's apply function gets those very
draws (`tests/torch_training_refs.py` repeats the JAX key splits), so the
outputs must agree: poses to atol 1e-5 (float32 rotations composed in
another order), `is_positive` exactly. The port's own draws (a
`torch.Generator`) have the layout of the JAX ones and, over 2000+
samples, the intended shares, each to +-0.03 (about 3 standard errors at
that count): a positive forced into 70% of the samples that lack one;
hard negatives at `coarse_hard_neg_frac`; Haar-uniform rotations, whose
trace has mean 0 and mean square 1 (to +-0.05).
"""

import math

import jax
import numpy as np
import pytest
import torch

from megapose6d_tpu.training.forward_loss import make_hypotheses as j_make_hypotheses
from megapose6d_tpu_torch.ops.se3 import geodesic_distance, random_rotations
from megapose6d_tpu_torch.training import forward_loss as tfl
from megapose6d_tpu_torch.training.config import TrainingConfig
from tests.torch_training_refs import batches, j_db, jax_hypotheses_draws, jcfg, scene, t_db

METHODS = {
    "coarse_z_up+auto-depth": 1,
    "refiner_gt+noise": 2,
    "coarse_classif_multiview_paper": 4,
    "coarse_classif_grid": 4,
}


def cfg_for(method: str, **kw) -> TrainingConfig:
    return TrainingConfig(hypotheses_init_method=method, n_hypotheses=METHODS[method], **kw)


@pytest.fixture(scope="module")
def dbs():
    return j_db(), t_db()


@pytest.mark.parametrize("method", list(METHODS))
def test_make_hypotheses_matches_jax(dbs, method):
    jdb, tdb_ = dbs
    cfg = cfg_for(method)
    sc = scene(np.random.RandomState(3), 6, [0, 1, 1, 0, 1, 0])
    jb, tb = batches(sc, jdb, tdb_)
    key = jax.random.PRNGKey(11)
    jc = jcfg(cfg)
    TCO_j, pos_j = jax.jit(lambda k, b: j_make_hypotheses(k, jc, b, jdb.select(b.mesh_idx)))(key, jb)
    draws = jax_hypotheses_draws(key, cfg, 6)
    port_draws = tfl.draw_hypotheses(cfg, 6, torch.Generator().manual_seed(0))
    assert {k: (v.shape, v.dtype) for k, v in draws.items()} == {
        k: (v.shape, v.dtype) for k, v in port_draws.items()}
    TCO_t, pos_t = tfl.make_hypotheses(cfg, tb, tdb_.select(tb.mesh_idx), draws)
    assert TCO_t.shape == (6, cfg.n_hypotheses, 4, 4)
    np.testing.assert_allclose(np.asarray(TCO_j), TCO_t.numpy(), atol=1e-5, rtol=0)
    if pos_j is None:
        assert pos_t is None
    else:
        np.testing.assert_array_equal(np.asarray(pos_j), pos_t.numpy())
        if method == "coarse_classif_grid":
            assert 0 < pos_t.sum() < pos_t.numel()


def test_port_draws_statistics(dbs):
    """The port's generator over 2400 samples of each coarse method."""
    jdb, tdb_ = dbs
    B = 2400
    sc = scene(np.random.RandomState(5), B, [0, 1] * (B // 2))
    _, tb = batches(sc, jdb, tdb_)
    meshes = tdb_.select(tb.mesh_idx)
    g = torch.Generator().manual_seed(7)

    cfg = cfg_for("coarse_classif_multiview_paper")
    _, pos = tfl.make_hypotheses(cfg, tb, meshes, tfl.draw_hypotheses(cfg, B, g))
    H, n = cfg.n_hypotheses, tfl.MULTIVIEW_PAPER_CANDIDATES
    p_lucky = 1 - math.comb(n - 1, H) / math.comb(n, H)  # candidate 0 among the H drawn
    assert abs(pos.any(1).float().mean().item() - (p_lucky + (1 - p_lucky) * 0.7)) < 0.03

    cfg = cfg_for("coarse_classif_grid")
    draws = tfl.draw_hypotheses(cfg, B, g)
    TCO, _ = tfl.make_hypotheses(cfg, tb, meshes, draws)
    ang = torch.rad2deg(geodesic_distance(TCO[..., :3, :3], tb.TCO[:, None, :3, :3]))  # [B, H]
    slot = torch.nn.functional.one_hot(draws["pos_slot"], H).bool()
    haar_within = lambda deg: (math.radians(deg) - math.sin(math.radians(deg))) / math.pi
    frac, hard_max = cfg.coarse_hard_neg_frac, cfg.coarse_hard_neg_max_deg
    # Other slots: hard (all within hard_max) or Haar-uniform.
    other = (ang[~slot] <= hard_max).float().mean().item()
    assert abs(other - (frac + (1 - frac) * haar_within(hard_max))) < 0.03
    # The positive's slot: forced (within 0.8 x the positive angle) or an other.
    pos_deg = 0.8 * cfg.coarse_pos_angle_deg
    forced = (ang[slot] <= pos_deg).float().mean().item()
    p_other = frac * pos_deg / hard_max + (1 - frac) * haar_within(pos_deg)
    assert abs(forced - (0.7 + 0.3 * p_other)) < 0.03

    R = random_rotations(draws["rot"])
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1).flatten()
    assert abs(tr.mean().item()) < 0.05 and abs((tr**2).mean().item() - 1) < 0.05
