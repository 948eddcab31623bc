"""Port vs JAX: the HTML scene viewer (`visualization/scene_viewer.py`).

The cases of `tests/test_scene_viewer.py` through the port, each holding
the same assertions; and on the same inputs the port's HTML file equals
the JAX package's byte for byte (its own copy of the HTML/JS template),
and `get_pointcloud` equals the JAX function's (points and pixels).
"""

import json
import re

import numpy as np
import pytest
import torch

from megapose6d_tpu.data.scene_dataset import SceneObservation as JSceneObservation
from megapose6d_tpu.data.types import CameraData as JCameraData
from megapose6d_tpu.data.types import ObjectData as JObjectData
from megapose6d_tpu.inference.types import make_pose_estimates as j_make_pose_estimates
from megapose6d_tpu.meshes.io import make_cube
from megapose6d_tpu.visualization import scene_viewer as jsv
from megapose6d_tpu_torch.data.scene_dataset import SceneObservation
from megapose6d_tpu_torch.data.tensor_collection import TensorCollection
from megapose6d_tpu_torch.data.types import CameraData, ObjectData
from megapose6d_tpu_torch.visualization import scene_viewer as tsv


def _scene_json(html: str) -> dict:
    m = re.search(r'<script type="application/json" id="scene-data">(.*?)</script>', html, re.S)
    assert m, "embedded scene payload not found"
    return json.loads(m.group(1))


def _standalone(sv, tmp_path, name):
    cube = make_cube(0.05)
    pose = np.eye(4)
    pose[:3, 3] = [0.1, 0.0, 0.5]
    viewer = sv.SceneViewer(title="test scene")
    viewer.add_mesh("gt/cube", cube.vertices, cube.faces, TWO=pose)
    viewer.add_frame("pred", pose, length=0.08)
    viewer.add_bbox("box", [0.1, 0.1, 0.1], T=pose)
    viewer.add_pointcloud("pc", np.random.default_rng(0).random((50, 3)).astype(np.float32))
    viewer.add_camera("cam", np.diag([300.0, 300.0, 1.0]), (240, 320))
    return viewer.write_html(tmp_path / name)


def _from_observation(port: bool, tmp_path, name):
    cube = make_cube(0.04)
    TWO = np.eye(4, dtype=np.float32)
    TWO[2, 3] = 0.6
    K = np.array([[120.0, 0, 32], [0, 120.0, 24], [0, 0, 1]], np.float32)
    depth = np.zeros((48, 64), np.float32)
    depth[10:20, 10:20] = 0.6
    if port:
        obs = SceneObservation(rgb=np.full((48, 64, 3), 128, np.uint8), depth=depth,
                               camera_data=CameraData(K=K, resolution=(48, 64)),
                               object_datas=[ObjectData(label="cube", TWO=TWO)])
        estimates, viewer = TensorCollection(["cube"], poses=torch.as_tensor(TWO[None])), tsv.SceneViewer()
    else:
        obs = JSceneObservation(rgb=np.full((48, 64, 3), 128, np.uint8), depth=depth,
                                camera_data=JCameraData(K=K, resolution=(48, 64)),
                                object_datas=[JObjectData(label="cube", TWO=TWO)])
        estimates, viewer = j_make_pose_estimates(["cube"], TWO[None]), jsv.SceneViewer()
    viewer.add_scene_observation(obs, lambda label: (cube.vertices, cube.faces, None))
    viewer.add_pose_estimates(estimates, lambda label: (cube.vertices, cube.faces, None))
    return viewer.write_html(tmp_path / name)


def test_viewer_writes_standalone_html(tmp_path):
    out = _standalone(tsv, tmp_path, "scene.html")
    html = out.read_text()
    assert "<script src" not in html and "http" not in html.split("</title>")[1][:2000]
    scene = _scene_json(html)
    assert [n["type"] for n in scene["nodes"]] == ["mesh", "frame", "bbox", "points", "camera"]
    mesh = scene["nodes"][0]
    assert mesh["pose"][0][0] == 1.0 and mesh["pose"][2][3] == 0.5
    import base64

    verts = np.frombuffer(base64.b64decode(mesh["vertices"]["data"]), np.float32).reshape(-1, 3)
    np.testing.assert_allclose(verts, make_cube(0.05).vertices, atol=1e-6)
    assert html == _standalone(jsv, tmp_path, "jax.html").read_text()


def test_get_pointcloud_backprojection():
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    depth = np.zeros((48, 64), np.float32)
    depth[24, 32] = 2.0
    depth[24, 42] = 1.0
    pts = tsv.get_pointcloud(depth, K)
    assert pts.shape == (2, 3)
    by_z = pts[np.argsort(pts[:, 2])]
    np.testing.assert_allclose(by_z[0], [0.1, 0.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(by_z[1], [0.0, 0.0, 2.0], atol=1e-6)
    np.testing.assert_array_equal(pts, jsv.get_pointcloud(depth, K))


def test_viewer_from_scene_observation(tmp_path):
    out = _from_observation(True, tmp_path, "obs.html")
    scene = _scene_json(out.read_text())
    names = {n["name"] for n in scene["nodes"]}
    assert {"gt/cube", "gt_frame/cube", "depth", "camera", "pred/0_cube", "pred_frame/0_cube"} <= names
    assert next(n for n in scene["nodes"] if n["name"] == "pred/0_cube")["opacity"] < 1.0
    assert out.read_text() == _from_observation(False, tmp_path, "jax.html").read_text()


def test_viewer_hostile_title_and_names(tmp_path):
    htmls = []
    for sv in (tsv, jsv):
        viewer = sv.SceneViewer(title="bob's \\ <scenes> \"quoted\"")
        cube = make_cube(0.02)
        viewer.add_mesh("it's a </script> cube", cube.vertices, cube.faces)
        htmls.append(viewer.write_html(tmp_path / f"{sv.__name__}.html").read_text())
    scene = _scene_json(htmls[0])
    assert scene["title"] == "bob's \\ <scenes> \"quoted\""
    assert scene["nodes"][0]["name"] == "it's a </script> cube"
    assert htmls[0] == htmls[1]


@pytest.mark.parametrize("max_points", [100, 10_000])
def test_pointcloud_color_alignment(max_points):
    depth = np.random.default_rng(1).uniform(0.5, 1.5, (40, 50)).astype(np.float32)
    K = np.asarray([[50.0, 0, 25], [0, 50.0, 20], [0, 0, 1]])
    pts, vs, us = tsv.get_pointcloud(depth, K, max_points=max_points, return_pixels=True)
    assert len(pts) == len(vs) == len(us) == min(max_points, depth.size)
    np.testing.assert_allclose(pts[:, 2], depth[vs, us], rtol=1e-6)
    for a, b in zip((pts, vs, us), jsv.get_pointcloud(depth, K, max_points=max_points, return_pixels=True)):
        np.testing.assert_array_equal(a, b)
