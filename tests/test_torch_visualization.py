"""Port vs JAX: `visualization/plotter.py` and
`training/visualization.py`, drawn in numpy and written through the
port's PNG writer.

- `make_contour_overlay` and `save_image_grid` equal the JAX package's
  arrays exactly, and their PNGs decode (`utils/png.py`) to those arrays,
  as the JAX package's PIL-written PNGs do.
- `plot_pose_overlay`'s overlay (scan renders of a cube and a sphere over
  a seeded image) equals the JAX package's, and so does its contour PNG
  (the renders agree within 1e-5, `tests/test_torch_rasterizer_scan.py`,
  and no blended value lies that close to a level boundary here).
- `plot_detections` draws each box's 2-pixel outline in lime at the
  detection's pixels and its label above it, leaves the rest of the image
  as it was, and returns the image the JAX package's figure shows.
- `make_debug_visualization` of a refiner and of a coarse model with the
  JAX package's weights: the grid has one [crop | render] row per sample,
  within one level of the JAX package's grid, equal on at least 98% of
  the values (the crops agree within 1e-4, `tests/test_torch_pose_predictor.py`,
  and a value that close to a level boundary may truncate to the
  neighbouring level; measured 98.97% equal), and its PNG round-trips.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from megapose6d_tpu.inference.types import make_detections as jmake_detections
from megapose6d_tpu.visualization import plotter as jp
from megapose6d_tpu_torch.inference.types import make_detections
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.utils.png import read_png
from megapose6d_tpu_torch.visualization import plotter as tp
from tests.torch_training_refs import j_db, t_db

pin_f32()
H, W = 96, 128
K = np.asarray([[130.0, 0, 64], [0, 130.0, 48], [0, 0, 1]], np.float32)


def test_contour_overlay_matches_jax(rng, tmp_path):
    rgb = rng.uniform(size=(H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W), bool)
    mask[20:60, 30:90] = True
    mask[40:50, 5:20] = True
    for thickness in (1, 2):
        a = jp.make_contour_overlay(rgb, mask, thickness=thickness, out_path=tmp_path / "j.png")
        b = tp.make_contour_overlay(rgb, torch.as_tensor(mask), thickness=thickness, out_path=tmp_path / "t.png")
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(read_png(tmp_path / "t.png"), b)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "j.png")), read_png(tmp_path / "t.png"))


def test_image_grid_matches_jax(rng, tmp_path):
    images = [rng.uniform(size=(20, 30, 3)).astype(np.float32), (rng.uniform(size=(16, 24)) * 255).astype(np.uint8),
              rng.uniform(size=(20, 30, 3)).astype(np.float32)]
    a = jp.save_image_grid(images, tmp_path / "j.png", n_cols=2)
    b = tp.save_image_grid(images, tmp_path / "t.png", n_cols=2)
    np.testing.assert_array_equal(a, b)
    assert b.shape == (40, 60, 3)
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"), b)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "j.png")), b)


def test_pose_overlay_matches_jax(rng, tmp_path):
    rgb = (rng.uniform(size=(H, W, 3)) * 255).astype(np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[0, :3, 3] = [-0.06, 0.0, 0.5]
    poses[1, :3, 3] = [0.05, 0.02, 0.45]
    labels = ["cube", "sphere"]
    a = jp.plot_pose_overlay(rgb, j_db(), labels, poses, K, out_path=tmp_path / "j.png",
                             contour_out_path=tmp_path / "jc.png")
    b = tp.plot_pose_overlay(rgb, t_db(), labels, torch.as_tensor(poses), K, out_path=tmp_path / "t.png",
                             contour_out_path=tmp_path / "tc.png")
    assert a.shape == b.shape == (H, W, 3) and a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(b, a)
    assert (b != rgb).any(-1).sum() > 500  # both objects blended in
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"), b)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "jc.png")), read_png(tmp_path / "tc.png"))


def test_plot_detections_draws_boxes(rng, tmp_path):
    rgb = (rng.uniform(size=(H, W, 3)) * 200).astype(np.uint8)
    boxes = np.asarray([[10.0, 20.0, 50.0, 70.0], [60.0, 30.0, 120.0, 90.0]], np.float32)
    dets = make_detections(["obj_000001", "cube"], boxes, device="cpu")
    img = tp.plot_detections(torch.as_tensor(rgb.astype(np.float32) / 255.0), dets, out_path=tmp_path / "d.png")
    img_u8 = tp.plot_detections(rgb, dets)
    lime = np.array([0, 255, 0], np.uint8)
    for x1, y1, x2, y2 in boxes.astype(int):
        for k in (0, 1):
            assert (img_u8[y1 + k, x1:x2 + 1] == lime).all() and (img_u8[y2 - k, x1:x2 + 1] == lime).all()
            assert (img_u8[y1:y2 + 1, x1 + k] == lime).all() and (img_u8[y1:y2 + 1, x2 - k] == lime).all()
        assert (img_u8[y1 + 3 : y2 - 2, x1 + 3 : x2 - 2] == rgb[y1 + 3 : y2 - 2, x1 + 3 : x2 - 2]).all()
        label_rows = img_u8[y1 - 3 - tp.GLYPH_H : y1 - 3, x1 : x1 + 30]
        assert (label_rows == lime).all(-1).sum() > 10  # the label's pixels above the box
    changed = (img_u8 != rgb).any(-1)
    assert changed.sum() < 0.2 * H * W
    np.testing.assert_array_equal(read_png(tmp_path / "d.png"), img)
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    # The JAX package draws the same boxes into a matplotlib figure of the same image.
    fig = jp.plot_detections(rgb, jmake_detections(["obj_000001", "cube"], boxes))
    np.testing.assert_array_equal(fig.axes[0].images[0].get_array(), rgb)
    assert len(fig.axes[0].patches) == 2 and [t.get_text() for t in fig.axes[0].texts] == ["obj_000001", "cube"]


@pytest.mark.parametrize("kind", ["refiner", "coarse"])
def test_debug_visualization_matches_jax(rng, tmp_path, kind):
    from megapose6d_tpu.models import pose_predictor as jpp
    from megapose6d_tpu.training import visualization as jviz
    from megapose6d_tpu_torch.models import pose_predictor as tpp
    from megapose6d_tpu_torch.training import visualization as tviz
    from megapose6d_tpu_torch.training.forward_loss import BatchPoseData
    from tests.test_torch_pose_predictor import init_both, scene
    from tests.torch_training_refs import JBatchPoseData

    if kind == "refiner":
        kw = dict(n_rendered_views=2, multiview_type="TCO+front_1view")
        jm, params, tm, jdb, tdb_ = init_both(kw, jpp.make_refiner_config, tpp.make_refiner_config, 1)
    else:
        jm, params, tm, jdb, tdb_ = init_both({}, jpp.make_coarse_config, tpp.make_coarse_config, 0)
    img, Kb, TCO = scene(rng, 3)
    idx = np.asarray([0, 1, 0])
    boxes = np.tile(np.asarray([[20.0, 10.0, 60.0, 50.0]], np.float32), (3, 1))
    jb = JBatchPoseData(rgbs=jnp.asarray(img), K=jnp.asarray(Kb), TCO=jnp.asarray(TCO), bboxes=jnp.asarray(boxes),
                        mesh_idx=jnp.asarray(idx))
    tb = BatchPoseData(rgbs=torch.as_tensor(img), K=torch.as_tensor(Kb), TCO=torch.as_tensor(TCO),
                       bboxes=torch.as_tensor(boxes), mesh_idx=torch.as_tensor(idx))
    a = jviz.make_debug_visualization(params, jm, jb, jdb, tmp_path / "j.png", max_samples=2)
    b = tviz.make_debug_visualization(tm, tb, tdb_, tmp_path / "t.png", max_samples=2)
    rh, rw = tm.cfg.render_size
    assert b.shape == a.shape == (2 * rh, 2 * rw, 3)
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.98, (d.max(), (d == 0).mean())
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"), b)
    assert b[:, rw:].max() > 0  # renders in the right column
