"""Calls written against the JAX package give the JAX results on the port:
the positional orders, options, methods and constants that
`tests/test_torch_signatures.py` holds by name, here held by value on
the same inputs (numpy, from a seed) through both packages.

Tolerances: exact for integer data, labels, names, files and draws of
one generator; float arrays as stated per case (the two packages' float32
arithmetic is the same op for op in these functions, so atol 1e-6 unless
noted).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_depth import K as DEPTH_K
from tests.test_torch_depth import assert_poses_close, cube_scene  # noqa: F401 (a fixture)
from tests.test_torch_pose_dataset import _pair
from tests.test_torch_scene_gen import dbs  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
SYNTHDEMO = ROOT / "runs/ar_dr/synthdemo"


def T_(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# Observations, detections, datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [False, True])
def test_observation_from_numpy_positional(depth):
    """`from_numpy(rgb, depth, K)`: the JAX order (the port's was
    `(rgb, K, device, depth)`)."""
    from megapose6d_tpu.data.types import ObservationTensor as J
    from megapose6d_tpu_torch.data.types import ObservationTensor as T

    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)
    d = rng.uniform(0.3, 1.0, (12, 16)).astype(np.float32) if depth else None
    K = np.asarray([[50.0, 0, 8], [0, 50.0, 6], [0, 0, 1]], np.float32)
    j, t = J.from_numpy(rgb, d, K), T.from_numpy(rgb, d, K, device="cpu")
    np.testing.assert_array_equal(t.images.numpy(), j.images)
    np.testing.assert_array_equal(t.K.numpy(), j.K)
    assert t.channels == j.channels == (4 if depth else 3)
    with pytest.raises(ValueError, match="K"):
        T.from_numpy(rgb, d, device="cpu")


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_observation_torch_layout_is_valid_resolution(scale):
    from megapose6d_tpu.data.types import ObservationTensor as J
    from megapose6d_tpu_torch.data.types import ObservationTensor as T

    rng = np.random.RandomState(1)
    nchw = (rng.rand(2, 4, 6, 10) * scale).astype(np.float32)
    K = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    j, t = J.from_torch_layout(nchw, K), T.from_torch_layout(nchw, K, device="cpu")
    np.testing.assert_array_equal(t.images.numpy(), j.images)
    assert tuple(t.resolution) == tuple(j.resolution) == (6, 10)
    assert t.is_valid() == j.is_valid() == (scale == 1.0)


def test_make_detections_batch_im_ids():
    from megapose6d_tpu.inference.types import make_detections as jmake
    from megapose6d_tpu_torch.inference.types import make_detections as tmake

    boxes = np.asarray([[1, 2, 10, 12], [3, 4, 20, 25]], np.float32)
    j = jmake(["a", "b"], boxes, [0.5, 0.9], [0, 1])
    t = tmake(["a", "b"], boxes, [0.5, 0.9], [0, 1], device="cpu")
    for k in j.infos.columns:
        np.testing.assert_array_equal(j.infos[k].to_numpy(), t.infos[k], err_msg=k)
    assert list(t.infos["batch_im_id"]) == [0, 1]
    np.testing.assert_array_equal(t.bboxes.numpy(), np.asarray(j.bboxes))


def test_bop_dataset_positional_label_format():
    """`BOPDataset(dir, label_format, split)`, the JAX order."""
    from megapose6d_tpu.data.bop_scene_dataset import BOPDataset as J
    from megapose6d_tpu_torch.data.bop_scene_dataset import BOPDataset as T

    j, t = J(SYNTHDEMO, "demo_{label}", "test"), T(SYNTHDEMO, "demo_{label}", "test")
    assert len(t) == len(j) > 0
    for i in (0, len(j) - 1):
        labels = [o.label for o in t[i].object_datas]
        assert labels == [o.label for o in j[i].object_datas] and labels[0].startswith("demo_")


# ---------------------------------------------------------------------------
# Meshes and object datasets
# ---------------------------------------------------------------------------


def _objects(pkg):
    io = importlib.import_module(f"{pkg}.meshes.io")
    mdb = importlib.import_module(f"{pkg}.meshes.mesh_db")
    return mdb, mdb.RigidObjectDataset([
        mdb.RigidObject(label="cube", mesh=io.make_cube(0.04), ypr_offset_deg=(10.0, 0.0, -5.0)),
        mdb.RigidObject(label="sphere", mesh=io.make_uv_sphere(0.03, 8, 12)),
    ])


def test_mesh_db_positional_pads_and_labels():
    """`batched(align, n_vertices_pad, n_faces_pad)`, `n_labels`,
    `get_object_by_label` and the `ypr_offset_deg` field."""
    jm, jobjs = _objects("megapose6d_tpu")
    tm, tobjs = _objects("megapose6d_tpu_torch")
    j = jm.MeshDataBase.from_object_ds(jobjs, n_points=32).batched(32, 256, 512)
    t = tm.MeshDataBase.from_object_ds(tobjs, n_points=32).batched(32, 256, 512, device="cpu")
    assert t.vertices.shape == j.vertices.shape == (2, 256, 3) and t.faces.shape == j.faces.shape == (2, 512, 3)
    np.testing.assert_array_equal(t.faces.numpy(), np.asarray(j.faces))
    np.testing.assert_allclose(t.vertices.numpy(), np.asarray(j.vertices), atol=1e-6)
    assert t.n_labels == j.n_labels == 2
    assert t.replace(labels=("a", "b")).labels == j.replace(labels=("a", "b")).labels
    for ds in (jobjs, tobjs):
        assert ds.get_object_by_label("cube").ypr_offset_deg == (10.0, 0.0, -5.0)
        assert ds.get_object_by_label("sphere").ypr_offset_deg == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("size,cells,seed", [(64, 8, 3), (128, 16, 0), (30, 5, 9)])
def test_make_random_texture(size, cells, seed):
    from megapose6d_tpu.meshes.io import make_random_texture as j
    from megapose6d_tpu_torch.meshes.io import make_random_texture as t

    np.testing.assert_array_equal(t(size, cells, seed), j(size, cells, seed))


def test_modelnet_object_dataset_rescaled(tmp_path):
    from megapose6d_tpu.data.object_datasets import make_modelnet_object_dataset as j
    from megapose6d_tpu_torch.data.object_datasets import make_modelnet_object_dataset as t

    base = tmp_path / "chair" / "test"
    base.mkdir(parents=True)
    for i in range(3):
        (base / f"chair_{i:04d}.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    for kw in (dict(rescaled=False), dict(n_objects=2, rescaled=True)):
        a, b = j(tmp_path, "chair", "test", **kw), t(tmp_path, "chair", "test", **kw)
        assert [(o.label, str(o.mesh_path), o.mesh_units) for o in a.objects] == \
            [(o.label, str(o.mesh_path), o.mesh_units) for o in b.objects]


# ---------------------------------------------------------------------------
# Dataset writers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("units", ["m", "mm"])
def test_write_bop_models_mesh_units(tmp_path, units):
    from megapose6d_tpu.data.bop_writer import write_bop_models as jw
    from megapose6d_tpu.meshes.io import make_cube as jcube
    from megapose6d_tpu_torch.data.bop_writer import write_bop_models as tw
    from megapose6d_tpu_torch.meshes.io import make_cube as tcube

    size = 0.04 if units == "m" else 40.0
    jw([(1, jcube(size))], tmp_path / "j", mesh_units=units)
    tw([(1, tcube(size))], tmp_path / "t", units)
    a = json.loads((tmp_path / "j/models_info.json").read_text())
    b = json.loads((tmp_path / "t/models_info.json").read_text())
    assert a.keys() == b.keys() and a["1"].keys() == b["1"].keys()
    for k in a["1"]:
        assert b["1"][k] == pytest.approx(a["1"][k], abs=1e-3), k
    assert a["1"]["size_x"] == pytest.approx(80.0, abs=1e-3)


def test_write_scene_ds_as_bop_label_to_obj_id(tmp_path):
    from megapose6d_tpu.data.bop_writer import write_scene_ds_as_bop as jw
    from megapose6d_tpu_torch.data.bop_writer import write_scene_ds_as_bop as tw

    ids = {"obj_000001": 11, "obj_000002": 22, "obj_000003": 33}
    pairs = [_pair(i, 40, 60) for i in range(2)]
    jw(iter([p[0] for p in pairs]), tmp_path / "j", "test", ids.get)
    tw(iter([p[1] for p in pairs]), tmp_path / "t", "test", ids.get)
    a = json.loads((tmp_path / "j/test/000000/scene_gt.json").read_text())
    b = json.loads((tmp_path / "t/test/000000/scene_gt.json").read_text())
    assert [[r["obj_id"] for r in a[v]] for v in a] == [[r["obj_id"] for r in b[v]] for v in b]
    assert {r["obj_id"] for v in b for r in b[v]} <= {11, 22, 33}


def test_write_scene_ds_as_wds_shard_format(tmp_path):
    from megapose6d_tpu.data.web_scene_dataset import write_scene_ds_as_wds as jw
    from megapose6d_tpu_torch.data.web_scene_dataset import WebSceneDataset
    from megapose6d_tpu_torch.data.web_scene_dataset import write_scene_ds_as_wds as tw

    pairs = [_pair(i, 40, 60) for i in range(3)]
    fmt = "part-{:03d}.tar"
    a = jw(iter([p[0] for p in pairs]), tmp_path / "j", 2, fmt, 4)
    b = tw(iter([p[1] for p in pairs]), tmp_path / "t", 2, fmt, 4)
    assert [p.name for p in a] == [p.name for p in b] == ["part-004.tar", "part-005.tar"]
    ds = WebSceneDataset(tmp_path / "t")
    assert len(ds) == 3
    np.testing.assert_array_equal(ds[2].rgb, pairs[2][1].rgb)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def test_get_K_crop_resize_positional():
    from megapose6d_tpu.ops import camera as jcam
    from megapose6d_tpu_torch.ops import camera as tcam

    rng = np.random.RandomState(2)
    K = np.tile(np.asarray([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32), (3, 1, 1))
    boxes = np.sort(rng.uniform(0, 300, (3, 2, 2)), 1).reshape(3, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    j = jcam.get_K_crop_resize(jnp.asarray(K), jnp.asarray(boxes), (240, 320), (120, 160))
    t = tcam.get_K_crop_resize(T_(K), T_(boxes), (240, 320), (120, 160))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("fn", ["tco_init_from_boxes_autodepth_with_R", "tco_init_from_boxes_zup_autodepth"])
def test_pose_init_valid(fn):
    """`valid` leaves the masked points out of the extent: a far point
    masked off changes nothing; unmasked, it changes the depth."""
    from megapose6d_tpu.ops import pose_init as jpi
    from megapose6d_tpu_torch.ops import pose_init as tpi

    rng = np.random.RandomState(4)
    B, N = 3, 20
    pts = rng.uniform(-0.04, 0.04, (B, N, 3)).astype(np.float32)
    pts[:, -1] = 0.5  # a padded point far out
    valid = np.ones((B, N), bool)
    valid[:, -1] = False
    boxes = np.asarray([[40, 30, 90, 80]] * B, np.float32)
    K = np.tile(np.asarray([[200.0, 0, 64], [0, 200.0, 48], [0, 0, 1]], np.float32), (B, 1, 1))
    R = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    args = (boxes, pts, K, R) if fn.endswith("_R") else (boxes, pts, K)
    outs = []
    for v in (valid, None):
        j = getattr(jpi, fn)(*map(jnp.asarray, args), None if v is None else jnp.asarray(v))
        t = getattr(tpi, fn)(*map(T_, args), None if v is None else T_(v))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
        outs.append(t)
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("max_children", [None, 3, 40])
def test_build_prune_table_max_children(max_children):
    from megapose6d_tpu.ops.so3_grid import build_prune_table as j
    from megapose6d_tpu.ops.so3_grid import make_so3_grid as jgrid
    from megapose6d_tpu_torch.ops.so3_grid import build_prune_table as t

    grid, parent = np.asarray(jgrid(72)), np.asarray(jgrid(8))
    (jc, jv), (tc, tv) = j(grid, parent, max_children), t(grid, parent, max_children)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)


def test_icp_refine_pose_mask(cube_scene):  # noqa: F811
    """`icp_refine_pose(key, TCO_pred, depth_measured, depth_rendered, K,
    mask)`: the measured points restricted to `mask`, one key per object
    (the JAX function under `vmap`). Poses to 1e-3 degree and mm, the
    residual to rtol 1e-3."""
    from megapose6d_tpu.ops import icp as jicp
    from megapose6d_tpu_torch.ops import icp as ticp
    from megapose6d_tpu_torch.ops._precision import pin_f32

    pin_f32()
    measured, rendered, TCO = cube_scene
    K = DEPTH_K
    mask = np.zeros(measured.shape, bool)
    mask[:, : measured.shape[1] // 2 + 6] = True
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    fn = jax.jit(jax.vmap(lambda k, T, dr: jicp.icp_refine_pose(
        k, T, jnp.asarray(measured), dr, jnp.asarray(K), jnp.asarray(mask), 512, 25)))
    ja = fn(keys, jnp.asarray(TCO), jnp.asarray(rendered))
    tb = ticp.icp_refine_pose(np.asarray(keys), T_(TCO), T_(measured), T_(rendered), T_(K), T_(mask), 512, 25)
    unmasked = ticp.icp_refine_pose(np.asarray(keys), T_(TCO), T_(measured), T_(rendered), T_(K), None, 512, 25)
    np.testing.assert_array_equal(np.asarray(ja.valid), tb.valid.numpy())
    assert_poses_close(np.asarray(ja.T_delta) @ TCO, tb.T_delta.numpy() @ TCO, 1e-3, 1e-3)
    np.testing.assert_allclose(tb.residual.numpy(), np.asarray(ja.residual), rtol=1e-3, atol=1e-7)
    assert not torch.equal(unmasked.T_delta, tb.T_delta)


# ---------------------------------------------------------------------------
# Loaders, augmentations
# ---------------------------------------------------------------------------


def test_pose_batch_factory_without_rgb_augmentation():
    """`PoseBatchFactory(..., apply_rgb_augmentation=False)` (seventh
    positional): the JAX package's batch, bit for bit."""
    import random

    from megapose6d_tpu.data.loader import PoseBatchFactory as J
    from megapose6d_tpu_torch.data.loader import PoseBatchFactory as T

    args = (("synthdemo.bop19",), ("obj_000001", "obj_000002"), 2, (60, 80), False, 10.0, False,
            str(ROOT / "runs/ar_dr"))
    batches = []
    for cls in (J, T):
        random.seed(3)
        np.random.seed(3)
        batches.append(next(cls(*args)(3)))
    for k in ("rgbs", "K", "TCO", "bboxes", "mesh_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(batches[0], k)), np.asarray(getattr(batches[1], k)),
                                      err_msg=k)
    assert T(*args).apply_rgb_augmentation is False


@pytest.mark.parametrize("prefetch", [1, 3, 8])
def test_parallel_batch_loader_prefetch(prefetch):
    """`ParallelBatchLoader(factory, n_workers, seed, prefetch)`: at least
    2 batches ahead, as the JAX loader's queue."""
    from megapose6d_tpu.data.loader import ParallelBatchLoader as J
    from megapose6d_tpu_torch.data.loader import ParallelBatchLoader as T

    factory = lambda seed: iter(range(seed, seed + 5))  # noqa: E731
    j, t = J(factory, 2, 7, prefetch), T(factory, 2, 7, prefetch)
    assert (t.n_workers, t.seed, t.prefetch) == (j.n_workers, j.seed, j.prefetch) == (2, 7, max(2, prefetch))


@pytest.mark.parametrize("kind", ["PillowSharpness", "PillowContrast", "PillowBrightness", "PillowColor"])
def test_pillow_enhancer(kind):
    """`cls.enhancer(img).enhance(factor)`: PIL's ImageEnhance on the
    image, bit for bit."""
    import PIL.Image

    from megapose6d_tpu.data import augmentations as ja
    from megapose6d_tpu_torch.data import augmentations as ta

    rgb = np.random.RandomState(5).randint(0, 256, (20, 24, 3)).astype(np.uint8)
    for factor in (0.3, 1.7):
        want = np.asarray(getattr(ja, kind).enhancer(PIL.Image.fromarray(rgb)).enhance(factor))
        np.testing.assert_array_equal(getattr(ta, kind).enhancer(rgb).enhance(factor), want)


# ---------------------------------------------------------------------------
# Configuration constants, the evaluation sweep
# ---------------------------------------------------------------------------


def test_config_constants():
    from megapose6d_tpu import config as jc
    from megapose6d_tpu.evaluation import eval_config as je
    from megapose6d_tpu_torch import config as tc
    from megapose6d_tpu_torch.evaluation import eval_config as te

    for name in ("LOCAL_DATA_DIR", "BOP_DS_DIR", "WDS_DS_DIR", "EXP_DIR", "EXAMPLES_DIR"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert te.BOP_TEST_DATASETS == je.BOP_TEST_DATASETS and len(te.BOP_TEST_DATASETS) == 7


def test_eval_config_positional():
    """The JAX package's positional fields bind the same way; the port's
    own (`*_weights`, `data_dir`, `device`) are keyword-only."""
    from megapose6d_tpu.evaluation.eval_config import EvalConfig as J
    from megapose6d_tpu_torch.evaluation.eval_config import EvalConfig as T

    args = ("det", "coarse", "ref", "lmo.bop19")
    j, t = J(*args), T(*args, data_dir="x")
    for f in dataclasses.fields(J):
        if f.name not in ("inference", "hardware"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.data_dir == "x" and t.device == "cuda"


def test_run_full_eval_default_datasets(tmp_path, monkeypatch):
    """With no `ds_names`, both sweeps visit the seven BOP19 test sets, in
    the same order (`run_eval` recorded in both)."""
    from megapose6d_tpu.evaluation.eval_config import FullEvalConfig as JCfg
    from megapose6d_tpu.scripts import run_full_eval as jfe
    from megapose6d_tpu_torch.evaluation.eval_config import FullEvalConfig as TCfg
    from megapose6d_tpu_torch.scripts import run_full_eval as tfe

    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jfe), ("port", tfe)):
        def run_eval(cfg, name=name):
            seen[name].append(cfg.ds_name)
            out = tmp_path / name / cfg.ds_name
            out.mkdir(parents=True, exist_ok=True)
            return {"save_dir": str(out), "summary": {}, "results_path": out / "results.npz", "pred_keys": []}

        monkeypatch.setattr(mod, "run_eval", run_eval)
    jfe.run_full_eval(JCfg(save_dir=str(tmp_path / "jax")))
    tfe.run_full_eval(TCfg(save_dir=str(tmp_path / "port")))
    assert seen["port"] == seen["jax"] == ["lmo.bop19", "tless.bop19", "tudl.bop19", "icbin.bop19",
                                           "itodd.bop19", "hb.bop19", "ycbv.bop19"]


# ---------------------------------------------------------------------------
# Script-level helpers under the JAX package's names
# ---------------------------------------------------------------------------


def test_build_world_positional():
    """`build_world(max_faces, return_objects, labels)` and
    `build_bop_world(world)`: the JAX package's worlds."""
    from megapose6d_tpu.scripts.demo_ar_baseline import build_bop_world as jbop
    from megapose6d_tpu.scripts.demo_synthetic_e2e import build_world as jbuild
    from megapose6d_tpu_torch.scripts.demo_ar_baseline import build_bop_world as tbop
    from megapose6d_tpu_torch.scripts.demo_synthetic_e2e import build_world as tbuild

    jdb, jobjs = jbuild(512, True, ("a", "b"))
    tdb_, tobjs = tbuild(512, True, ("a", "b"), device="cpu")
    assert tobjs.labels == jobjs.labels == ["a", "b"] and tdb_.labels == tuple(jdb.labels)
    np.testing.assert_array_equal(tdb_.faces.numpy(), np.asarray(jdb.faces))
    np.testing.assert_allclose(tdb_.vertices.numpy(), np.asarray(jdb.vertices), atol=1e-6)
    (jdb, jobjs), (tdb_, tobjs) = jbop("novel"), tbop("novel", device="cpu")
    assert tobjs.labels == jobjs.labels
    np.testing.assert_array_equal(tdb_.faces.numpy(), np.asarray(jdb.faces))


def test_scene_renderer_and_detector_batches_by_jax_name(dbs):  # noqa: F811
    """`make_scene_renderer(mesh_db, n_obj, resolution, f, background,
    shadows, ibl, unlit)`, positional: the JAX renderer's scene to
    `tests/test_torch_scene_gen.py`'s tolerances; `make_batch_fn` takes
    the JAX arguments in its order and gives the port's batches (held
    against the JAX package's by `tests/test_torch_detector_training.py`)."""
    from megapose6d_tpu.scripts import generate_synthetic_dataset as jgen
    from megapose6d_tpu_torch.meshes import worlds
    from megapose6d_tpu_torch.scripts import generate_synthetic_dataset as gen
    from megapose6d_tpu_torch.scripts import run_detector_training as rdt
    from megapose6d_tpu_torch.utils import threefry
    from tests.test_torch_scene_gen import RES, assert_scene_close

    jdb, tdb = dbs
    args = (2, RES, 120.0, True, False, False, False)
    jr, tr = jgen.make_scene_renderer(jdb, *args), gen.make_scene_renderer(tdb, *args)
    assert (tr.n_obj, tr.shadows, tr.ibl, tr.unlit) == (2, False, False, False)
    key = jax.random.PRNGKey(3)
    assert_scene_close(jr(key), tr(np.asarray(key)))
    db = worlds.build_world(512, device="cpu")
    batch = rdt.make_batch_fn(db, 2, (48, 64), 2, 80.0, True)(threefry.PRNGKey(0))
    want = rdt.DetectorBatches(db, 2, (48, 64), 2, 80.0, with_seg=True)(threefry.PRNGKey(0))
    assert len(batch) == 5 and all(torch.equal(a, b) for a, b in zip(batch, want))


def test_load_or_init_models_positional():
    """`load_or_init_models(objects, coarse_run, refiner_run, render_size,
    max_faces)`: the JAX order; seeded models at that render size and a
    mesh database of that many faces."""
    from megapose6d_tpu_torch.inference.load_model import load_or_init_models
    from megapose6d_tpu_torch.meshes import worlds

    coarse, refiner, db = load_or_init_models(worlds.world_objects(), None, None, (48, 64), 256, device="cpu")
    assert tuple(coarse.cfg.render_size) == tuple(refiner.cfg.render_size) == (48, 64)
    assert db.faces.shape[1] == 256
