"""Port vs JAX: the reference MegaPose's torch checkpoints and the
trainable BatchNorm backbones.

- `interop.torch_convert.pose_predictor_state_dict_from_reference` on the
  torch WideResNet34 pose model that `tests/test_torch_interop.py`
  rebuilds from the reference source (randomised weights and BatchNorm
  statistics): the port's state_dict equals the JAX converter's result
  carried across by `interop.from_jax` (bit for bit), and the port's
  `net_forward` at 64x80 equals the JAX package's and the torch model's
  to rtol 1e-4 (float32 sums in another order). `load_torch_pose_checkpoint`
  reads it back from a `checkpoint.pth.tar`, wrapped or bare, and
  `build_model` serves it.
- Unknown keys raise with their list; the old-key shim renames as the JAX
  package's does.
- `zoo_resnet18-train` in train mode from the JAX params: the output and
  the updated running statistics equal flax's
  `apply(..., mutable=["batch_stats"])` to 1e-5 (relative to each
  tensor's largest entry), for a float32 batch of 4 at 32x32.
- The counterpart of `test_zoo_backbone_trainable_bn_overfit`: 30 Adam
  steps on one batch halve the loss, the running statistics move, and
  the eval mode consumes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.interop import pose_predictor_params_from_torch
from megapose6d_tpu.models import backbones as jbackbones
from megapose6d_tpu.models.pose_predictor import PosePredictor as JPosePredictor
from megapose6d_tpu.models.pose_predictor import PosePredictorConfig as JPosePredictorConfig
from megapose6d_tpu_torch.inference.load_model import build_model
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.interop.torch_convert import (
    change_keys_of_older_models,
    load_torch_pose_checkpoint,
    pose_predictor_state_dict_from_reference,
)
from megapose6d_tpu_torch.models import backbones
from megapose6d_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.training.train import Adam
from tests.test_torch_interop import TorchZooPosePredictor, _randomize

pin_f32()
C = 9  # refiner RGB, one view: 3 observed + (3 rgb + 3 normals)
CFG = dict(backbone="zoo_resnet34", render_size=(32, 48), n_rendered_views=1, multiview_type="TCO+front_1view",
           render_normals=True, predict_pose_update=True, predict_rendered_views_logits=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module, restored after it: the test
    workers' thread pools otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    tm = TorchZooPosePredictor(C).eval()
    _randomize(tm)
    return tm


def rel_gap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_converter_matches_jax_and_the_reference(reference, tmp_path):
    sd = pose_predictor_state_dict_from_reference(reference.state_dict())
    variables = pose_predictor_params_from_torch(reference.state_dict())
    via_jax = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    assert set(sd) == set(via_jax)
    for k in sd:
        assert torch.equal(sd[k], via_jax[k]), k

    model = PosePredictor(PosePredictorConfig(**CFG)).eval()
    model.load_state_dict(sd)
    x = np.random.RandomState(0).rand(2, 64, 80, C).astype(np.float32)
    with torch.no_grad():
        port = model.net_forward(torch.from_numpy(x))["pose"].numpy()
        ref = reference(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    jout = JPosePredictor(JPosePredictorConfig(**CFG)).apply(variables, jnp.asarray(x),
                                                             method=JPosePredictor.net_forward)
    for want in (np.asarray(jout["pose"]), ref):
        np.testing.assert_allclose(port, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())))

    torch.save({"state_dict": reference.state_dict(), "epoch": 3}, tmp_path / "checkpoint.pth.tar")
    torch.save(reference.state_dict(), tmp_path / "bare.pth.tar")
    for name in ("checkpoint.pth.tar", "bare.pth.tar"):
        loaded = load_torch_pose_checkpoint(tmp_path / name)
        assert all(torch.equal(loaded[k], sd[k]) for k in sd) and set(loaded) == set(sd)
    served = build_model(None, tmp_path / "checkpoint.pth.tar",
                         lambda render_size: PosePredictorConfig(**{**CFG, "render_size": render_size}),
                         render_size=(32, 48), device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(served.net_forward(torch.from_numpy(x))["pose"].numpy(), port)


def test_converter_rejects_unknown_keys(reference):
    sd = dict(reference.state_dict())
    sd["mystery.layer.weight"] = torch.zeros(3)
    sd["backbone.layer1.0.bn1.mystery"] = torch.zeros(3)
    with pytest.raises(ValueError, match="mystery.layer.weight.*backbone.layer1.0.bn1.mystery|"
                                         "backbone.layer1.0.bn1.mystery.*mystery.layer.weight"):
        pose_predictor_state_dict_from_reference(sd)


def test_old_key_shim_matches_jax():
    from megapose6d_tpu.interop import change_keys_of_older_models as j_change_keys

    sd = {"backbone.backbone.conv1.weight": 1, "backbone.head.0.weight": 2, "pose_fc.bias": 3}
    assert change_keys_of_older_models(sd) == j_change_keys(sd) == {
        "backbone.conv1.weight": 1, "views_logits_head.weight": 2, "pose_fc.bias": 3}
    old = {"backbone.backbone.conv1.weight": torch.ones(64, C, 5, 5)}
    assert set(pose_predictor_state_dict_from_reference(old)) == {"backbone.stem.weight"}


def zoo18_train() -> torch.nn.Module:
    return backbones.make_backbone("zoo_resnet18-train", C, (32, 32))


def from_flax(variables) -> dict:
    """flax `ZooWideResNet` variables -> the port backbone's state_dict."""
    sd = state_dict_from_jax({"params": {"backbone": variables["params"]},
                              "batch_stats": {"backbone": variables["batch_stats"]}})
    return {k[len("backbone."):]: v for k, v in sd.items()}


def test_zoo_train_mode_matches_flax():
    jmodel = jbackbones.make_backbone("zoo_resnet18-train")
    x = np.random.RandomState(1).normal(size=(4, 32, 32, C)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # Non-trivial running statistics, so the update's old term counts.
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree.map(lambda a: a + 0.3, variables["batch_stats"])}
    with jax.default_matmul_precision("highest"):
        jout, updates = jmodel.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    model = zoo18_train().train()
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)))
    out = model(torch.from_numpy(x))
    assert rel_gap(out.detach().numpy(), jout) <= 1e-5
    want = from_flax({"params": variables["params"], "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])})
    got = model.state_dict()
    moved = 0
    for k, v in want.items():
        if "running" in k:
            assert rel_gap(got[k].numpy(), v.numpy()) <= 1e-5, k
            moved += int(not torch.equal(got[k], from_flax(jax.tree.map(np.asarray, variables))[k]))
    assert moved == sum("running" in k for k in want)  # every statistic moved
    # Eval mode normalizes with the running statistics and leaves them be.
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model(torch.from_numpy(x))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_zoo_backbone_trainable_bn_overfit():
    torch.manual_seed(0)
    model = zoo18_train().train()
    for m in model.modules():
        if isinstance(m, backbones.Conv):
            torch.nn.init.kaiming_normal_(m.weight, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 32, 32, C), generator=g)
    y = torch.randn((4, 512), generator=g) * 0.1
    params = list(model.parameters())
    opt = Adam(lambda count: 1e-3)
    state = Adam.init(params)
    losses = []
    for _ in range(30):
        loss = ((model(x) - y) ** 2).mean()
        opt.update(params, list(torch.autograd.grad(loss, params)), state)
        losses.append(loss.item())
    assert model.stem_bn.running_mean.abs().max() > 1e-4
    assert losses[-1] < 0.5 * losses[0], losses[::6]
    model.eval()
    with torch.no_grad():
        out = model(x)
    assert out.shape == (4, 512) and torch.isfinite(out).all()
