"""Port vs JAX: the public functions the port lacked, and `CameraData`'s
JSON.

Each is held against its JAX counterpart on the same inputs:
  - `CameraData.to_json` / `from_json` keep `camera_id` and `TWC_init`: the
    same JSON keys and values, and a round trip through either package's
    reader gives back every field (poses travel as float32 quaternions and
    translations, which the packages compute to within 1e-6);
  - `filter_detections`, `add_instance_id`, `make_cameras` and
    `make_pose_estimates` (`inference/types.py`, the last exported from
    `inference/`): the port's collections are pandas-free, so infos are
    compared column by column, and tensors exactly;
  - `load_qua_grid` on a `.qua` file written under `tmp_path` (float32
    rotations: within 1e-6, the two packages' float32 arithmetic);
  - `BOPEvalConfig`, `generate_save_key`, `HardwareConfig` and
    `make_urdf_dataset`.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from megapose6d_tpu.data import datasets_cfg as jcfg
from megapose6d_tpu.data.types import CameraData as JCameraData
from megapose6d_tpu.evaluation import eval_config as jeval
from megapose6d_tpu.inference import make_pose_estimates as jmake_pose_estimates
from megapose6d_tpu.inference import types as jtypes
from megapose6d_tpu.meshes import make_cube, save_ply
from megapose6d_tpu.ops import so3_grid as jso3
from megapose6d_tpu_torch.data import datasets_cfg as tcfg
from megapose6d_tpu_torch.data.types import CameraData
from megapose6d_tpu_torch.evaluation import eval_config as teval
from megapose6d_tpu_torch.inference import make_pose_estimates
from megapose6d_tpu_torch.inference import types as ttypes
from megapose6d_tpu_torch.ops import so3_grid as tso3


def _pose(rng) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T[:3, 3] = rng.normal(size=3)
    return T


CAMERAS = {
    "full": lambda rng: dict(K=np.array([[500.0, 0, 320], [0, 501, 240], [0, 0, 1]]), resolution=(480, 640),
                             TWC=_pose(rng), camera_id="cam_3", TWC_init=_pose(rng)),
    "id_only": lambda rng: dict(K=np.eye(3), camera_id="front"),
    "init_only": lambda rng: dict(TWC_init=_pose(rng), resolution=(10, 20)),
    "empty": lambda rng: {},
}


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_camera_data_json_round_trips(kind):
    fields = CAMERAS[kind](np.random.RandomState(len(kind)))
    j, t = JCameraData(**fields), CameraData(**fields)
    jd, td = json.loads(j.to_json()), json.loads(t.to_json())
    assert list(td) == list(jd)
    for k in jd:
        if k in ("TWC", "TWC_init"):
            for u, v in zip(jd[k], td[k]):
                np.testing.assert_allclose(v, u, atol=1e-6, err_msg=k)
        else:
            assert td[k] == jd[k], k
    for text in (j.to_json(), t.to_json()):
        a, b = JCameraData.from_json(text), CameraData.from_json(text)
        for f in dataclasses.fields(JCameraData):
            u, v = getattr(a, f.name), getattr(b, f.name)
            assert (u is None) == (v is None), f.name
            if isinstance(u, str) or u is None:
                assert u == v == getattr(t, f.name), f.name
            else:
                tol = 1e-6 if f.name in ("TWC", "TWC_init") else 0
                np.testing.assert_allclose(np.asarray(v), np.asarray(u), atol=tol, rtol=0, err_msg=f.name)
                np.testing.assert_allclose(np.asarray(getattr(t, f.name)), np.asarray(v), atol=1e-6, err_msg=f.name)
    assert json.loads(CameraData.from_json(t.to_json()).to_json()).keys() == td.keys()


def _detections(rng, n: int):
    labels = list(rng.choice(["obj_a", "obj_b", "obj_c"], n))
    boxes = rng.uniform(0, 100, (n, 4)).astype(np.float32)
    scores = np.round(rng.uniform(size=n), 1)  # ties among the scores
    ims = rng.randint(0, 3, n)
    j = jtypes.make_detections(labels, boxes, scores, ims)
    t = ttypes.make_detections(labels, boxes, scores, ims, device="cpu")
    return j, t


def _same(j, t) -> None:
    assert list(j.infos.columns) == list(t.infos)
    for k in j.infos.columns:
        np.testing.assert_array_equal(j.infos[k].to_numpy(), t.infos[k], err_msg=k)
    assert sorted(j.tensors) == sorted(t.tensors)
    for k, v in j.tensors.items():
        np.testing.assert_array_equal(np.asarray(v), t.tensors[k].numpy(), err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_filter_detections_and_instance_ids_match_jax(seed):
    rng = np.random.RandomState(seed)
    j, t = _detections(rng, [0, 1, 7, 25][seed])
    for labels in (None, ["obj_a"], ["obj_b", "obj_c", "nope"], []):
        for one in (False, True):
            _same(jtypes.filter_detections(j, labels, one), ttypes.filter_detections(t, labels, one))
    _same(jtypes.add_instance_id(j), ttypes.add_instance_id(t))


def test_make_cameras_and_pose_estimates_match_jax():
    rng = np.random.RandomState(3)
    cams = [JCameraData(K=rng.uniform(1, 500, (3, 3)), resolution=(48, 64)) for _ in range(3)]
    _same(jtypes.make_cameras(cams), ttypes.make_cameras([CameraData(K=c.K) for c in cams], device="cpu"))
    poses = np.stack([_pose(rng) for _ in range(4)])
    extra = {"score": rng.uniform(size=4), "batch_im_id": np.arange(4)}
    for ex in (None, extra):
        _same(jmake_pose_estimates(["a", "b", "a", "c"], poses, ex),
              make_pose_estimates(["a", "b", "a", "c"], poses, ex, device="cpu"))


def test_load_qua_grid_matches_jax(tmp_path):
    q = np.random.RandomState(0).normal(size=(37, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    path = tmp_path / "grid.qua"
    path.write_text("\n".join(" ".join(f"{x:.9f}" for x in row) for row in q) + "\n")
    j = np.asarray(jso3.load_qua_grid(path))
    t = tso3.load_qua_grid(path, device="cpu")
    assert t.dtype == torch.float32 and t.shape == (37, 3, 3)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6)
    (tmp_path / "bad.qua").write_text("1 2 3\n")
    with pytest.raises(ValueError):
        tso3.load_qua_grid(tmp_path / "bad.qua", device="cpu")


def test_eval_config_types_match_jax():
    assert [f.name for f in dataclasses.fields(teval.BOPEvalConfig)] == [
        f.name for f in dataclasses.fields(jeval.BOPEvalConfig)]
    kw = dict(results_path="r.npz", dataset="ycbv.bop19", split="test", eval_dir="e", method="final")
    assert dataclasses.asdict(teval.BOPEvalConfig(**kw)) == dataclasses.asdict(jeval.BOPEvalConfig(**kw))
    assert dataclasses.asdict(teval.HardwareConfig()) == dataclasses.asdict(jeval.HardwareConfig())
    for det, coarse in (("gt", "SO3_grid"), ("detector", "external")):
        assert teval.generate_save_key(det, coarse) == jeval.generate_save_key(det, coarse)


def test_make_urdf_dataset_matches_jax(tmp_path):
    mesh_dir = tmp_path / "urdfs" / "mine"
    mesh_dir.mkdir(parents=True)
    for name in ("obj_b", "obj_a"):
        save_ply(make_cube(0.02), mesh_dir / f"{name}.ply")
    (mesh_dir / "notes.json").write_text(json.dumps({}))
    a, b = jcfg.make_urdf_dataset("mine", data_dir=tmp_path), tcfg.make_urdf_dataset("mine", data_dir=tmp_path)
    assert [o.label for o in a.objects] == [o.label for o in b.objects] == ["obj_a", "obj_b"]
    for o, p in zip(a.objects, b.objects):
        assert Path(o.mesh_path) == Path(p.mesh_path) and o.mesh_units == p.mesh_units
