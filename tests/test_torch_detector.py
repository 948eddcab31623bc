"""Port vs JAX: the CenterNet detector (`models/detector.py`) at the JAX
tests' size (64x96, width 16, 2 classes), with the JAX params (seeded, then
moved by a seeded normal so that the biases are not zero) carried across
by `interop.from_jax.detector_state_dict_from_jax`.

Tolerances (float32 convolutions summed in another order): the forward's
heads within 1e-4, at even and odd input sizes, with and without the mask
head; decoded boxes within 1e-3 px, scores within 1e-6 and classes and
the order of the peaks equal, on a map where most cells tie at exactly 0
and on an all-zero map (every cell ties); the losses within 1e-5
relative and their gradients with respect to the heads within 1e-5 of
each tensor's largest entry (`jax.grad`); `Detector.get_detections`: the
same detections in the same order at three thresholds and with one
instance per class, boxes within 1e-3 px, and the per-instance masks
equal except at pixels whose probability is within 1e-5 of 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.data import ObservationTensor as JObservation
from megapose6d_tpu.models import detector as jdet
from megapose6d_tpu_torch.data.types import ObservationTensor
from megapose6d_tpu_torch.interop.from_jax import detector_state_dict_from_jax
from megapose6d_tpu_torch.models import detector as tdet
from megapose6d_tpu_torch.ops._precision import pin_f32

pin_f32()
H, W = 64, 96


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops gain nothing from threads and slow down many times
    over when the test workers' thread pools contend for the cores; one
    thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(hw=(H, W), masks=True, seed=0):
    cfg = jdet.DetectorConfig(n_classes=2, width=16, stride=4, max_detections=8, predict_masks=masks)
    jm = jdet.CenterNetDetector(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1,) + hw + (3,)))
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(leaves))
    params = jax.tree.unflatten(tree, [x + 0.05 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    tm = tdet.CenterNetDetector(tdet.DetectorConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
    tm.load_state_dict(detector_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


@pytest.mark.parametrize("hw,masks", [((64, 96), True), ((64, 96), False), ((66, 98), True), ((61, 83), False)])
def test_forward_matches_jax(hw, masks):
    jm, params, tm = models(hw, masks)
    x = np.random.RandomState(0).rand(2, *hw, 3).astype(np.float32)
    jout = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tout = tm(torch.as_tensor(x))
    assert set(tout) == set(jout) == {"heatmap", "wh", "offset"} | ({"seg"} if masks else set())
    for k, v in jout.items():
        assert tuple(tout[k].shape) == v.shape, k
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(v), atol=1e-4, rtol=0, err_msg=k)


def random_outputs(rng, B=2, h=16, w=24, C=2, ties=False):
    heat = rng.normal(0, 2, (B, h, w, C)).astype(np.float32)
    if ties:  # sigmoid(-200) == 0: every cell but a few peaks ties at exactly 0
        heat[:] = -200.0
        heat[0, 3, 5, 1], heat[0, 10, 20, 0], heat[1, 7, 7, 0] = 3.0, 1.0, 2.0
    return {"heatmap": heat, "wh": np.abs(rng.normal(3, 1, (B, h, w, 2))).astype(np.float32),
            "offset": rng.rand(B, h, w, 2).astype(np.float32),
            "seg": rng.normal(0, 1, (B, h, w, C)).astype(np.float32)}


@pytest.mark.parametrize("case", ["random", "ties", "all_zero"])
def test_decode_matches_jax(case):
    out = random_outputs(np.random.RandomState(1), ties=case == "ties")
    if case == "all_zero":
        out["heatmap"][:] = 0.0  # every cell is its own 3x3 max: all tie at 0.5
    j = jdet.decode_detections({k: jnp.asarray(v) for k, v in out.items()}, 4, 12)
    t = tdet.decode_detections({k: torch.as_tensor(v) for k, v in out.items()}, 4, 12)
    np.testing.assert_array_equal(t["classes"].numpy(), np.asarray(j["classes"]))
    np.testing.assert_allclose(t["scores"].numpy(), np.asarray(j["scores"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t["boxes"].numpy(), np.asarray(j["boxes"]), atol=1e-3, rtol=0)
    if case == "ties":  # image 0 has two peaks; its other entries tie at 0
        assert np.asarray(j["scores"])[0, 2:].max() == 0.0


def gt_targets():
    boxes = np.asarray([[[20.0, 16, 44, 40], [60, 20, 80, 44], [0, 0, 0, 0]],
                        [[5.0, 5, 30, 25], [40, 30, 90, 62], [96, 64, 0, 0]]], np.float32)
    classes = np.asarray([[0, 1, 0], [1, 1, 0]], np.int32)
    valid = np.asarray([[True, True, False], [True, True, False]])
    seg = np.full((2, H, W), -1, np.int32)
    seg[0, 16:40, 20:44], seg[0, 20:44, 60:80], seg[1, 5:25, 5:30], seg[1, 30:62, 40:90] = 0, 1, 1, 1
    return boxes, classes, valid, seg


def test_losses_and_gradients_match_jax():
    out = random_outputs(np.random.RandomState(2))
    boxes, classes, valid, seg = gt_targets()

    def jloss(o):
        loss, aux = jdet.detection_loss(o, jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid), 4)
        seg_l = jdet.segmentation_loss(o, jnp.asarray(seg), 4)
        return loss + seg_l, (loss, seg_l, aux)

    (jtotal, (jl, jseg, jaux)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    tl, taux = tdet.detection_loss(tout, torch.as_tensor(boxes), torch.as_tensor(classes), torch.as_tensor(valid), 4)
    tseg = tdet.segmentation_loss(tout, torch.as_tensor(seg), 4)
    (tl + tseg).backward()
    tl, tseg, taux = tl.detach(), tseg.detach(), {k: v.detach() for k, v in taux.items()}
    for a, b in [(tl, jl), (tseg, jseg)] + [(taux[k], jaux[k]) for k in jaux]:
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)
    for k, g in jgrads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(tout[k].grad.numpy(), g, atol=1e-5 * np.abs(g).max(), rtol=0, err_msg=k)


def test_get_detections_matches_jax():
    jm, params, tm = models()
    img = np.random.RandomState(3).rand(1, H, W, 3).astype(np.float32)
    K = np.eye(3, dtype=np.float32)[None]
    labels = ["obj_a", "obj_b"]
    jd = jdet.Detector(jm, params, labels)
    td = tdet.Detector(tm, labels)
    for th, oipc in ((0.0, False), (0.5, False), (0.7, False), (0.0, True)):
        j = jd.get_detections(JObservation(images=img, K=K), detection_th=th, one_instance_per_class=oipc)
        t = td.get_detections(ObservationTensor(torch.as_tensor(img), torch.as_tensor(K)), detection_th=th,
                              one_instance_per_class=oipc)
        assert list(t.infos["label"]) == list(j.infos["label"]), (th, oipc)
        np.testing.assert_allclose(t.infos["score"], j.infos["score"].to_numpy(), atol=1e-6)
        np.testing.assert_array_equal(t.infos["instance_id"], j.infos["instance_id"].to_numpy())
        np.testing.assert_allclose(t.bboxes.numpy(), np.asarray(j.bboxes), atol=1e-3)
        seg = td.infer(torch.as_tensor(img))["seg"][0].numpy()
        near = np.abs(seg[..., [labels.index(l) for l in t.infos["label"]]].transpose(2, 0, 1) - 0.5) < 1e-5
        differ = t.masks.numpy() != np.asarray(j.masks)
        assert not (differ & ~near).any(), (th, oipc, differ.sum())
    assert len(td.get_detections(ObservationTensor(torch.as_tensor(img), torch.as_tensor(K)), 0.0, True)) <= 2
