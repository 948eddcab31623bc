"""Port vs JAX (optax): the detector's trainer
(`scripts/run_detector_training.py`).

- `DetectorBatches` (the JAX package's `make_batch_fn`) at 64x96 (2 scenes of 2 objects, masks): boxes, classes,
  valid flags and class maps equal (the scenes' draws are bit for bit);
  rgb as `tests/test_torch_scene_gen.py` holds it.
- Two Adam steps under the warm-up + cosine schedule (20 steps: warm-up
  2, so the first update has a zero learning rate) from the same params
  on the same batch: losses within 1e-5 relative, the schedule's
  learning rates equal, and the params after two steps within 1e-7 of
  optax's at 99.9% of the entries, all within a tenth of the step
  (5e-5): Adam scales every entry to a step of ~lr, also an entry whose
  gradient is ~1e-4 of its tensor's largest, where float32 sums in
  another order leave a relative error of a few percent (measured: 1 of
  ~90k entries beyond 1e-7, by 3.6e-5).
- A run stopped after its first step (`max_seconds=0`) and resumed equals
  the unbroken run exactly (params, Adam's moments and count, the log);
  the run directory has the JAX layout.
- `evaluate_detector` with the committed `runs/detector_long` weights on
  one batch of 4 demo-world scenes at 240x320: the same ground truth,
  recall and class accuracy, the mean IoU within 1e-4 and the mask IoU
  within 1e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from megapose6d_tpu.evaluation.evaluation import load_detector as jload_detector
from megapose6d_tpu.meshes.mesh_db import MeshDataBase as JMeshDataBase
from megapose6d_tpu.models import detector as jdet
from megapose6d_tpu.scripts import demo_ar_baseline as jdemo
from megapose6d_tpu.scripts import generate_synthetic_dataset as jgen
from megapose6d_tpu.scripts import run_detector_training as jtrain
from megapose6d_tpu_torch.interop.from_jax import detector_state_dict_from_jax
from megapose6d_tpu_torch.meshes import worlds
from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase
from megapose6d_tpu_torch.models import detector as tdet
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.scripts import generate_synthetic_dataset as gen
from megapose6d_tpu_torch.scripts import run_detector_training as ttrain
from tests.test_torch_scene_gen import assert_rgb_close, rgb8

pin_f32()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops gain nothing from threads and slow down many times
    over when the test workers' thread pools contend for the cores; one
    thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_batch_fn_matches_jax():
    jdb = JMeshDataBase.from_object_ds(jgen._default_objects(), max_faces=2048, n_points=64, n_sym=2).batched(align=32)
    tdb = MeshDataBase.from_object_ds(gen._default_objects(), max_faces=2048, n_points=64, n_sym=2).batched(
        align=32, device="cpu")
    key = jax.random.PRNGKey(4)
    j = [np.asarray(x) for x in jtrain.make_batch_fn(jdb, 2, (64, 96), 2, f=120.0, with_seg=True)(key)]
    t = [x.numpy() for x in ttrain.DetectorBatches(tdb, 2, (64, 96), 2, f=120.0, with_seg=True)(np.asarray(key))]
    for i in range(2):
        assert_rgb_close(rgb8(t[0][i]), rgb8(j[0][i]))
    for a, b, name in zip(t[1:], j[1:], ("boxes", "classes", "valid", "class map")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert j[3].any() and (j[4] >= 0).any()


def test_two_steps_match_optax():
    cfg = jdet.DetectorConfig(n_classes=2, width=16, predict_masks=True)
    jm = jdet.CenterNetDetector(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    tm = tdet.CenterNetDetector(tdet.DetectorConfig(n_classes=2, width=16, predict_masks=True))
    tm.load_state_dict(detector_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.RandomState(0)
    batch = (rng.rand(2, 64, 96, 3).astype(np.float32),
             np.asarray([[[20.0, 16, 44, 40], [60, 20, 80, 44]], [[5.0, 5, 30, 25], [0, 0, 0, 0]]], np.float32),
             np.asarray([[0, 1], [1, 0]], np.int32), np.asarray([[True, True], [True, False]]),
             np.where(rng.rand(2, 64, 96) > 0.7, rng.randint(0, 2, (2, 64, 96)), -1).astype(np.int32))
    n_steps, lr = 20, 1e-3
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, 2, n_steps, lr * 0.01)
    tx = optax.adam(sched)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            out = jm.apply(p, jnp.asarray(batch[0]))
            loss, _ = jdet.detection_loss(out, *map(jnp.asarray, batch[1:4]), 4)
            return loss + jdet.segmentation_loss(out, jnp.asarray(batch[4]), 4)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    schedule = ttrain.warmup_cosine_decay_schedule(lr, 2, n_steps, lr * 0.01)
    optimizer = ttrain.Adam(schedule)
    t_state = optimizer.init(list(tm.parameters()))
    tbatch = tuple(torch.as_tensor(x) for x in batch)
    for i in range(2):
        params, opt_state, jloss = step(params, opt_state)
        tloss, _ = ttrain.train_step(tm, optimizer, t_state, tbatch)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        assert np.float32(schedule(i)) == np.float32(sched(i))
    want = detector_state_dict_from_jax(jax.tree.map(np.asarray, params))
    d = np.concatenate([(p - want[n]).abs().flatten().numpy() for n, p in tm.state_dict().items()])
    assert (d <= 1e-7).mean() >= 0.999 and d.max() <= 0.1 * lr / 2, ((d > 1e-7).sum(), d.size, d.max())


def test_resume_equals_unbroken(tmp_path):
    common = ["n_steps=4", "batch_size=2", "resolution=64,96", "width=16", "predict_masks=1", "log_every=1",
              "device=cpu", f"run_dir={tmp_path}"]
    unbroken = ttrain.main(common + ["run_id=unbroken"])
    first = ttrain.main(common + ["run_id=resumed", "max_seconds=0"])
    assert first.step == 1
    resumed = ttrain.main(common + ["run_id=resumed"])
    assert unbroken.step == resumed.step == 4 and resumed.opt_state["count"] == 4
    for (n, a), b in zip(unbroken.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for key in ("mu", "nu"):
        for a, b in zip(unbroken.opt_state[key], resumed.opt_state[key]):
            assert torch.equal(a, b)
    log = lambda run: [{k: v for k, v in json.loads(l).items() if k != "time"}
                       for l in (tmp_path / run / "log.txt").read_text().splitlines()]
    assert log("unbroken") == log("resumed") and len(log("unbroken")) == 4
    d = tmp_path / "resumed"
    assert json.loads((d / "labels.json").read_text()) == ["cube", "sphere"]
    assert json.loads((d / "config.json").read_text())["predict_masks"] is True
    assert (d / "checkpoints/latest.txt").read_text() == "4"
    assert {p.name for p in (d / "checkpoints").iterdir()} == {"step_1", "step_4", "final", "latest.txt"}


def test_evaluate_detector_matches_jax():
    n_scenes = 4
    jd = jload_detector("runs/detector_long")
    jdb = JMeshDataBase.from_object_ds(jdemo.build_bop_world()[1]).batched()
    tdb = MeshDataBase.from_object_ds(worlds.bop_world_objects("demo")).batched(device="cpu")
    jcfg = jd.model.cfg
    tm = tdet.CenterNetDetector(tdet.DetectorConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}))
    tm.load_state_dict(detector_state_dict_from_jax(jax.tree.map(np.asarray, jd.params)))
    j = jtrain.evaluate_detector(jd.model, jd.params, jd.model.cfg,
                                 jtrain.make_batch_fn(jdb, n_scenes, (240, 320), 2, with_seg=True), 1, True, seed=777)
    t = ttrain.evaluate_detector(tm.eval(), tm.cfg, ttrain.make_batch_fn(tdb, n_scenes, (240, 320), 2, with_seg=True),
                                 1, True, seed=777)
    assert t.keys() == j.keys() and t["n_gt"] == j["n_gt"] >= n_scenes
    assert t["recall@iou0.5"] == j["recall@iou0.5"] and t["class_accuracy"] == j["class_accuracy"]
    assert abs(t["mean_iou_matched"] - j["mean_iou_matched"]) <= 1e-4
    assert abs(t["mean_mask_iou"] - j["mean_mask_iou"]) <= 1e-3
    assert j["recall@iou0.5"] > 0.5  # the trained detector finds the objects
