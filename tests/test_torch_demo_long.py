"""The port's long-schedule demos and its end-to-end demo at a tiny size
on the CPU (the shape of `tests/test_demo_scripts.py`: 2 steps, batch 2,
48x64).

- `demo_long_refiner` trains, evaluates and checkpoints; its held-out
  scenes and their noised initial poses are the JAX script's (ground-truth
  poses within 1e-5, boxes within 1e-3 px, the noised poses within 1e-5:
  the same threefry draws), and `demo_finalize_pipeline refiner_dir=<its
  run>` consumes its checkpoint (step 2).
- `demo_long_coarse`: 2 steps, then a resumed segment to 3 with a
  ranking evaluation each; the resumed run's parameters equal an
  unbroken 3-step run's, bit for bit, and `history.json` holds one record
  per (step, grid).
- `demo_synthetic_e2e.main` writes the JAX script's report keys.
"""

import json

import jax
import numpy as np
import torch

from megapose6d_tpu.ops.se3 import add_pose_noise as j_add_pose_noise
from megapose6d_tpu.scripts.demo_synthetic_e2e import build_world as j_build_world
from megapose6d_tpu.training.train import synthetic_batch_fn as j_synthetic_batch_fn
from megapose6d_tpu_torch.inference.load_model import run_checkpoint
from megapose6d_tpu_torch.meshes.worlds import build_world
from megapose6d_tpu_torch.scripts import demo_finalize_pipeline, demo_long_coarse, demo_long_refiner
from megapose6d_tpu_torch.scripts import demo_synthetic_e2e
from tests.torch_production_refs import one_torch_thread  # noqa: F401 (autouse)

TINY = ["batch_size=2", "render=48,64", "n_eval=2", "backbone=resnet18-spatial", "device=cpu"]


def test_eval_set_is_the_jax_scripts():
    res = (48, 64)
    batch, TCO_init = demo_synthetic_e2e.eval_set(build_world(device="cpu"), 4, res)
    jb = jax.jit(j_synthetic_batch_fn(j_build_world(), 4, res, f=400.0))(jax.random.PRNGKey(9999))
    j_init = j_add_pose_noise(jax.random.PRNGKey(7), jb.TCO, euler_deg_std=(15, 15, 15), trans_std=(0.01, 0.01, 0.05))
    np.testing.assert_array_equal(batch.mesh_idx.numpy(), np.asarray(jb.mesh_idx))
    np.testing.assert_allclose(batch.TCO.numpy(), np.asarray(jb.TCO), atol=1e-5)
    np.testing.assert_allclose(batch.bboxes.numpy(), np.asarray(jb.bboxes), atol=1e-3)
    np.testing.assert_allclose(TCO_init.numpy(), np.asarray(j_init), atol=1e-5)


def test_demo_long_refiner_then_finalize(tmp_path):
    long_dir = tmp_path / "long"
    rec = demo_long_refiner.main([f"out_dir={long_dir}", "n_steps=2", "eval_every=2", "ckpt_every=2",
                                  "refine_iters=1"] + TINY)
    assert (long_dir / "report.json").exists()
    hist = json.loads((long_dir / "history.json").read_text())
    assert [h["step"] for h in hist] == [2] and rec["rot_init_deg"] > 0
    assert (long_dir / "checkpoints" / "latest.txt").read_text() == "2"
    assert run_checkpoint(long_dir) == long_dir / "checkpoints/epoch_2/state.pt"
    report = demo_finalize_pipeline.main([f"refiner_dir={long_dir}", f"out_dir={tmp_path / 'final'}",
                                          "coarse_steps=2", "so3=8", "n_eval=1", "refine_iters=1", "render=48,64",
                                          "batch_size=2", "backbone=resnet18-spatial", "device=cpu"])
    assert report["refiner_checkpoint_step"] == 2
    for k in ("init", "refined", "pipeline"):
        assert np.isfinite(report[k]["rot_deg"])
    assert (tmp_path / "final" / "report.json").exists()


def test_demo_long_coarse_resume_equals_unbroken(tmp_path):
    seg = ["grid=8,16", "eval_every=100"] + TINY
    demo_long_coarse.main([f"out_dir={tmp_path / 'part'}", "n_steps=2"] + seg)
    rec = demo_long_coarse.main([f"out_dir={tmp_path / 'part'}", "n_steps=3"] + seg)
    demo_long_coarse.main([f"out_dir={tmp_path / 'whole'}", "n_steps=3"] + seg)
    hist = json.loads((tmp_path / "part" / "history.json").read_text())
    assert [(h["step"], h["grid"]) for h in hist] == [(2, 8), (2, 16), (3, 8), (3, 16)]
    assert rec["step"] == 3 and rec["grid"] == 16 and 0 <= rec["top1_rot_err_deg_median"] <= 180
    a = torch.load(tmp_path / "part/checkpoints/epoch_3/state.pt", weights_only=True)
    b = torch.load(tmp_path / "whole/checkpoints/epoch_3/state.pt", weights_only=True)
    assert a["step"] == b["step"] == 3
    for k in b["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_demo_synthetic_e2e_main(tmp_path):
    report = demo_synthetic_e2e.main([f"out_dir={tmp_path}", "n_steps=2", "coarse_steps=2", "batch_size=2",
                                      "render=32,48", "input=48,64", "n_eval=2", "so3=8", "device=cpu"])
    assert set(report) == {"device", "refiner_losses", "coarse_losses", "refine_iters", "init", "refined",
                           "pipeline", "mean_diameter"}
    assert set(report["pipeline"]) == {"add_median", "rot_deg_median", "trans_median", "add_below_0.1d_frac"}
    assert all(np.isfinite(v) for d in ("init", "refined", "pipeline") for v in report[d].values())
    assert json.loads((tmp_path / "report.json").read_text()) == report
