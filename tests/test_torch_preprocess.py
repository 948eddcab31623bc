"""Port vs JAX: the mesh-database npz cache, `preprocess_meshes`, and the
port's `slim_run_dir`.

- The npz cache is read across in both directions: the JAX package's
  `save_batched_meshes` of the textured synthdemo database read by the
  port's `load_batched_meshes`, and the port's read by the JAX package's,
  every field equal (dtype and value) and the labels in order.
- `preprocess_meshes source=dir:<synthdemo models>` of both packages write
  the same arrays; the port's npz loads to the database the port builds
  directly, and renders (plain visibility pass) bit for bit as it.
- `slim_run_dir` on a port run of 2 epochs: only `epoch_2/` is left, its
  `state.pt` without Adam's state; `build_model` loads the same weights as
  before slimming, bit for bit, and `resume_run_id=` continues
  the slimmed run with the step restored and a fresh Adam, as the JAX
  package's params-and-step fallback does.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from megapose6d_tpu.meshes import mesh_db as jdb
from megapose6d_tpu.scripts import preprocess_meshes as j_preprocess
from megapose6d_tpu_torch.inference.load_model import build_model, run_checkpoint
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.meshes import mesh_db as tdb
from megapose6d_tpu_torch.ops import rasterizer_tiled as rt
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.scripts import preprocess_meshes, run_training, slim_run_dir
from tests.test_torch_textures import assert_same_db, synthdemo_dbs
from tests.test_torch_train import TINY

pin_f32()
MODELS = Path(__file__).resolve().parents[1] / "runs/ar_dr/synthdemo/models"


@pytest.fixture(scope="module")
def dbs():
    return synthdemo_dbs()


def test_npz_cache_read_across(tmp_path, dbs):
    j, t = dbs
    jdb.save_batched_meshes(tmp_path / "jax.npz", j)
    assert_same_db(j, tdb.load_batched_meshes(tmp_path / "jax.npz", device="cpu"))
    tdb.save_batched_meshes(tmp_path / "port.npz", t)
    assert_same_db(jdb.load_batched_meshes(tmp_path / "port.npz"), t)
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files) and "textures" in a.files
    assert a["labels"].dtype == b["labels"].dtype


def test_npz_cache_untextured(tmp_path):
    objs = tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04))])
    t = tdb.MeshDataBase.from_object_ds(objs, max_faces=64, n_points=16, n_sym=2).batched(align=8, device="cpu")
    tdb.save_batched_meshes(tmp_path / "plain.npz", t)
    back = tdb.load_batched_meshes(tmp_path / "plain.npz", device="cpu")
    assert back.textures is None and back.uvs is None and back.has_tex is None
    j = jdb.load_batched_meshes(tmp_path / "plain.npz")
    assert j.textures is None
    np.testing.assert_array_equal(np.asarray(j.vertices), t.vertices.numpy())


def test_preprocess_meshes_matches_jax(tmp_path, dbs):
    args = [f"source=dir:{MODELS}", "max_faces=4096", "n_points=2000", "n_sym=32"]
    out = preprocess_meshes.main(args + [f"out={tmp_path / 'port.npz'}"])
    j_preprocess.main(args + [f"out={tmp_path / 'jax.npz'}"])
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    loaded = tdb.load_batched_meshes(tmp_path / "port.npz", device="cpu")
    direct = dbs[1]
    assert_same_db(dbs[0], loaded)
    assert loaded.labels == out.labels == direct.labels
    TCO = torch.eye(4).expand(2, 4, 4).clone()
    TCO[:, 2, 3] = 0.3
    K = torch.tensor([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]]).expand(2, 3, 3)
    render = lambda m: rt.render_meshes_tiled(m.vertices, m.normals, m.colors, m.faces, m.face_valid, TCO, K,  # noqa
                                              (120, 160), **m.texture_kw)
    for x, y in zip(render(loaded), render(direct)):
        assert torch.equal(x, y)
    assert render(loaded).mask.sum() > 100


def test_slim_run_dir_then_load_and_resume(tmp_path):
    args = TINY + [f"run_dir={tmp_path}", "save_epoch_interval=1", "val_epoch_interval=100"]
    run_training.main(args + ["n_epochs=2", "run_id=part"])
    run = tmp_path / "part"
    before = build_model(run, None, None, device="cpu")
    full = torch.load(run / "checkpoints/epoch_2/state.pt", weights_only=True)
    assert "opt_state" in full and (run / "checkpoints/epoch_1").exists()
    kept = slim_run_dir.slim_run_dir(run)
    assert kept.name == "epoch_2"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["epoch_2", "latest.txt"]
    slim = torch.load(run / "checkpoints/epoch_2/state.pt", weights_only=True)
    assert set(slim) == {"params", "buffers", "step"} and slim["step"] == full["step"] == 2
    assert run_checkpoint(run) == run / "checkpoints/epoch_2/state.pt"
    after = build_model(run, None, None, device="cpu")
    for (n, a), b in zip(before.state_dict().items(), after.state_dict().values()):
        assert torch.equal(a, b), n
    resumed = run_training.main(args + ["n_epochs=3", "resume_run_id=part"])
    assert resumed.step == 3 and resumed.opt_state["count"] == 1  # the step restored, Adam afresh
    assert all(torch.isfinite(p).all() for p in resumed.params)
    shutil.rmtree(tmp_path)
