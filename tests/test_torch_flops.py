"""The port's FLOPs count (`PoseEstimator.fused_pipeline_flops_estimate`
and `fused_pipeline_cost_analysis`) at the small setup of
`tests/torch_production_refs.py` (grid 16, 48x64 renders, resnet18-spatial,
f32; 4 detections padded, 3 hypotheses, 2 iterations, chunks 16 / 8, so
the refiner and the rescore take a full chunk of 8 and a last one of 4).

- The estimate's parts sum to its `flops`, and it equals the cost
  analysis of one call exactly (both count every trip), unpruned and
  pruned 4 -> 2.
- `FlopCounterMode`'s convolution FLOPs of resnet18-spatial at the test's
  input size equal a count by hand from the layer shapes (2 x the
  multiply-adds of every output position, padded taps included).
- The estimate against the JAX package's estimate of the same
  configuration: XLA's cost analysis counts only the taps of a
  convolution window that fall on the input, not its padding, so at
  48x64, where the last stage's maps are 2x2, the port's count is the
  larger: measured 1.2226 (unpruned) and 1.2419 (pruned) times the JAX
  count, held to 0.1%. Per row of a call the ratio is ~1.36-1.38 for
  `score_views` and `refine_step`; the port's refiner and rescore
  count 12 rows where the JAX package pads its loop to 16.
"""

import pytest
import torch

from megapose6d_tpu_torch.models.backbones import ResNet
from tests.torch_production_refs import RENDER, make_scene
from tests.torch_production_refs import one_torch_thread  # noqa: F401 (autouse)

PRUNED = dict(SO3_prune_grid_size=4, SO3_prune_keep=2)
JAX_RATIO = {"unpruned": 1.2226, "pruned": 1.2419}


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.fixture(scope="module")
def estimates(scene):
    out = {}
    for name, kw in (("unpruned", {}), ("pruned", PRUNED)):
        est = scene.port_estimator(**kw)
        obs, dets = scene.port_request()
        out[name] = (est.fused_pipeline_flops_estimate(obs), est.fused_pipeline_cost_analysis(obs, dets))
    return out


@pytest.mark.parametrize("case", ["unpruned", "pruned"])
def test_estimate_parts_sum_and_equal_cost_analysis(estimates, case):
    est, cost = estimates[case]
    assert set(est) == {"flops", "flops_coarse", "flops_refine", "flops_rescore"}
    assert est["flops"] == est["flops_coarse"] + est["flops_refine"] + est["flops_rescore"]
    assert min(est.values()) > 0
    assert cost["flops"] == est["flops"]
    assert sum(cost["by_operator"].values()) == cost["flops"]
    assert cost["by_operator"]["aten.convolution"] > 0.9 * cost["flops"]


def conv_flops_by_hand(in_ch: int, hw: tuple[int, int], batch: int, stages=(2, 2, 2, 2), width: int = 64,
                       spatial_ch: int = 64) -> int:
    """2 x multiply-adds of every convolution of a ResNet-18 trunk with the
    spatial head, from the layer shapes."""
    total = 0
    h, w = hw

    def conv(cin, cout, k, s, p):
        nonlocal h, w, total
        h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        total += 2 * batch * h * w * cout * cin * k * k

    conv(in_ch, width, 7, 2, 3)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1  # max pool
    cin = width
    for i, n in enumerate(stages):
        cout = width * 2**i
        for b in range(n):
            s = 2 if (i > 0 and b == 0) else 1
            h0, w0 = h, w
            conv(cin, cout, 3, s, 1)
            conv(cout, cout, 3, 1, 1)
            if cin != cout or s != 1:
                h1, w1 = h, w
                h, w = h0, w0
                conv(cin, cout, 1, s, 0)
                assert (h, w) == (h1, w1)
            cin = cout
    conv(cin, spatial_ch, 1, 1, 0)
    return total


def test_resnet18_spatial_conv_flops_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    in_ch, B = 9, 3  # the coarse model's input: observation rgb + render rgb + normals
    net = ResNet(in_ch, RENDER, stage_sizes=(2, 2, 2, 2), pool="spatial")
    x = torch.zeros((B,) + RENDER + (in_ch,))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(x)
    counts = counter.get_flop_counts()["Global"]
    assert counts[torch.ops.aten.convolution] == conv_flops_by_hand(in_ch, RENDER, B)
    head_in = net.fc.in_features
    assert counts[torch.ops.aten.addmm] == 2 * B * head_in * net.fc.out_features


@pytest.mark.parametrize("case", ["unpruned", "pruned"])
def test_estimate_against_jax(scene, estimates, case):
    jest = scene.jax_estimator(**(PRUNED if case == "pruned" else {}))
    jout = jest.fused_pipeline_flops_estimate(scene.jax_request()[0])
    port = estimates[case][0]
    assert port["flops"] / jout["flops"] == pytest.approx(JAX_RATIO[case], rel=1e-3)
    # Per row the ratio is the same in every part (the padded taps); the
    # refiner and rescore differ by the padding of the JAX loop (16 rows vs 12).
    per_row = port["flops_coarse"] / jout["flops_coarse"]
    assert 1.3 < per_row < 1.45
    for k in ("flops_refine", "flops_rescore"):
        assert port[k] / jout[k] * 16 / 12 == pytest.approx(per_row, rel=0.03)
