"""Port vs JAX: the training loss and its gradients.

`forward_loss` of the refiner (2 views, `front_1view`, 2 iterations,
`random_ambient_light`) and of the coarse grid scorer (4 hypotheses)
runs in both packages at a small size: resnet18-spatial, 48x64 renders of
60x80 observations, batch 2, the 256-face cube and sphere of
`tests/test_torch_pose_predictor.py`, float32. The JAX params are carried
across with `interop.from_jax.state_dict_from_jax`, the JAX gradients are
mapped the same way, and the port gets the JAX package's own draws
(`tests/torch_training_refs.py`). The JAX side computes its contractions
at `Precision.HIGHEST`, the port with TF32 off.
Tolerances: the loss and each metric to rtol 1e-5; every gradient tensor
within 1e-4 of that tensor's largest absolute entry (the CNN's float32
sums run in another order in each package).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from megapose6d_tpu.training.forward_loss import forward_loss as j_forward_loss
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.training.config import TrainingConfig, make_coarse_cfg, make_refiner_cfg
from megapose6d_tpu_torch.training.forward_loss import forward_loss
from tests.torch_training_refs import (
    INPUT,
    RENDER,
    batches,
    init_jax_model,
    j_db,
    jax_forward_loss_draws,
    jcfg,
    scene,
    t_db,
)

pin_f32()
BASE = TrainingConfig(backbone_str="resnet18-spatial", input_resize=INPUT, render_size=RENDER,
                      batch_size=2, n_points_loss=32, compute_dtype="float32")
CASES = {
    "refiner": (make_refiner_cfg(BASE), dict(n_rendered_views=2, multiview_type="front_1view",
                                             n_iterations=2, random_ambient_light=True)),
    "coarse_grid": (make_coarse_cfg(BASE), dict(n_hypotheses=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_jax(case):
    base, kw = CASES[case]
    cfg = dataclasses.replace(base, **kw)
    jdb, tdb_ = j_db(), t_db()
    jb, tb = batches(scene(np.random.RandomState(2), 2, [0, 1]), jdb, tdb_)
    jmodel, params = init_jax_model(cfg, jdb, seed=4)
    key = jax.random.PRNGKey(9)
    jc = jcfg(cfg)

    def loss_fn(p):
        return j_forward_loss(p, jmodel, jc, jb, jdb, key, cfg.n_iterations)

    with jax.default_matmul_precision("highest"):
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tmodel = PosePredictor(PosePredictorConfig(**cfg.model_config_kwargs()))
    tmodel.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    draws = jax_forward_loss_draws(key, cfg, 2, tdb_.points.shape[1])
    tloss, tmetrics = forward_loss(tmodel, cfg, tb, tdb_, draws, cfg.n_iterations)
    names = [n for n, _ in tmodel.named_parameters()]
    tgrads = dict(zip(names, torch.autograd.grad(tloss, list(tmodel.parameters()))))

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    jg = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(jg) == set(tgrads)
    worst = 0.0
    for n, g in tgrads.items():
        ref = jg[n].numpy()
        scale = np.abs(ref).max()
        assert scale > 0, n
        gap = np.abs(g.numpy() - ref).max() / scale
        worst = max(worst, gap)
        assert gap <= 1e-4, (n, gap)
    assert worst > 0  # the two packages did compute separately
