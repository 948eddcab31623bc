"""Port vs JAX: SE(3), camera, SO(3) grid, pose init and multi-view ops.

The same numpy inputs (from a seed) go through the JAX function and its
`megapose6d_tpu_torch` counterpart on the CPU in float32. Tolerance: atol
1e-5 (f32 rounding of short chains of 3x3/4x4 products), relative where
values are pixel coordinates or depths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.ops import camera as jcam
from megapose6d_tpu.ops import multiview as jmv
from megapose6d_tpu.ops import pose_init as jpi
from megapose6d_tpu.ops import se3 as jse3
from megapose6d_tpu.ops import so3_grid as jgrid
from megapose6d_tpu_torch.ops import camera as tcam
from megapose6d_tpu_torch.ops import multiview as tmv
from megapose6d_tpu_torch.ops import pose_init as tpi
from megapose6d_tpu_torch.ops import se3 as tse3
from megapose6d_tpu_torch.ops import so3_grid as tgrid
from megapose6d_tpu_torch.ops._precision import pin_f32

ATOL = 1e-5

pin_f32()


def close(j, t, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), atol=atol, rtol=rtol)


def T_(x):
    return torch.as_tensor(np.asarray(x))


def random_poses(rng, n, z=0.6):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    R = np.asarray(jse3.rotmat_from_quat(jnp.asarray(q)))
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(scale=0.05, size=(n, 3)) + [0, 0, z]
    return T


def intrinsics(n):
    K = np.asarray([[400.0, 0, 159.5], [0, 410.0, 119.5], [0, 0, 1]], np.float32)
    return np.tile(K, (n, 1, 1))


def test_se3_ops(rng):
    T = random_poses(rng, 8)
    pts = rng.normal(scale=0.05, size=(8, 20, 3)).astype(np.float32)
    close(jse3.transform_pts(jnp.asarray(T), jnp.asarray(pts)), tse3.transform_pts(T_(T), T_(pts)))
    # A set of S transforms per batch element.
    TS = random_poses(rng, 8 * 3).reshape(8, 3, 4, 4)
    close(jse3.transform_pts(jnp.asarray(TS), jnp.asarray(pts)), tse3.transform_pts(T_(TS), T_(pts)))
    close(jse3.invert_se3(jnp.asarray(T)), tse3.invert_se3(T_(T)))
    close(jse3.make_se3(jnp.asarray(T[:, :3, :3]), jnp.asarray(T[:, :3, 3])),
          tse3.make_se3(T_(T[:, :3, :3]), T_(T[:, :3, 3])))
    noisy = T + rng.normal(scale=0.05, size=T.shape).astype(np.float32)
    close(jse3.normalize_T(jnp.asarray(noisy)), tse3.normalize_T(T_(noisy)))
    six = rng.normal(size=(8, 6)).astype(np.float32)
    close(jse3.rotmat_from_ortho6d(jnp.asarray(six)), tse3.rotmat_from_ortho6d(T_(six)))
    q = rng.normal(size=(8, 4)).astype(np.float32)
    close(jse3.rotmat_from_quat(jnp.asarray(q)), tse3.rotmat_from_quat(T_(q)))
    eul = rng.normal(size=(8, 3)).astype(np.float32)
    close(jse3.rotmat_from_euler_sxyz(jnp.asarray(eul)), tse3.rotmat_from_euler_sxyz(T_(eul)))


def test_camera_ops(rng):
    T = random_poses(rng, 6)
    K = intrinsics(6)
    pts = rng.normal(scale=0.05, size=(6, 30, 3)).astype(np.float32)
    uv_j = jcam.project_points_robust(jnp.asarray(pts), jnp.asarray(K), jnp.asarray(T))
    uv_t = tcam.project_points_robust(T_(pts), T_(K), T_(T))
    close(uv_j, uv_t, atol=1e-3, rtol=1e-6)  # pixels: f32 rounding of ~300 px values
    valid = rng.uniform(size=(6, 30)) > 0.3
    close(jcam.masked_boxes_from_uv(uv_j, jnp.asarray(valid)),
          tcam.masked_boxes_from_uv(uv_t, T_(valid)), atol=1e-3, rtol=1e-6)
    boxes = np.sort(rng.uniform(0, 300, size=(6, 2, 2)).astype(np.float32), axis=1)
    boxes = boxes.transpose(0, 2, 1).reshape(6, 4)[:, [0, 2, 1, 3]]
    close(jcam.get_K_crop_resize(jnp.asarray(K), jnp.asarray(boxes), (240, 320), (240, 320)),
          tcam.get_K_crop_resize(T_(K), T_(boxes), (240, 320)), atol=1e-3, rtol=1e-6)
    close(jcam.get_K_resize(jnp.asarray(K), (240, 320), (120, 160)),
          tcam.get_K_resize(T_(K), (240, 320), (120, 160)), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("n", [16, 576])
def test_so3_grid(n):
    np.testing.assert_array_equal(jgrid.super_fibonacci_quats(n), tgrid.super_fibonacci_quats(n))
    close(jgrid.make_so3_grid(n), tgrid.make_so3_grid(n, device="cpu"))


def test_pose_init_autodepth(rng):
    B = 12
    K = intrinsics(B)
    pts = rng.normal(scale=0.04, size=(B, 50, 3)).astype(np.float32)
    R = random_poses(rng, B)[:, :3, :3]
    x1y1 = rng.uniform(50, 200, size=(B, 2)).astype(np.float32)
    boxes = np.concatenate([x1y1, x1y1 + rng.uniform(20, 80, size=(B, 2))], -1).astype(np.float32)
    j = jpi.tco_init_from_boxes_autodepth_with_R(
        jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(K), jnp.asarray(R))
    t = tpi.tco_init_from_boxes_autodepth_with_R(T_(boxes), T_(pts), T_(K), T_(R))
    close(j, t, atol=ATOL, rtol=1e-6)


def test_pose_update_with_reference_point(rng):
    B = 10
    T = random_poses(rng, B)
    K = intrinsics(B)
    v = np.concatenate(
        [rng.normal(scale=2.0, size=(B, 2)), rng.uniform(0.8, 1.2, size=(B, 1))], -1
    ).astype(np.float32)
    v[0, 2] = 0.0  # the depth clamp
    dR = random_poses(rng, B)[:, :3, :3]
    tCR = T[:, :3, 3] + rng.normal(scale=0.01, size=(B, 3)).astype(np.float32)
    j = jpi.pose_update_with_reference_point(*map(jnp.asarray, (T, K, v, dR, tCR)))
    t = tpi.pose_update_with_reference_point(*map(T_, (T, K, v, dR, tCR)))
    close(j, t, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize(
    "mv_type,n_views,remove,inplane",
    [
        ("TCO+front_1view", 2, False, False),
        ("TCO+front_3views", 4, False, False),
        ("TCO+front_5views", 6, False, True),
        ("sphere_26views", 26, True, False),
        ("TCO+front_3views", 1, False, False),
    ],
)
def test_make_TCO_multiview(rng, mv_type, n_views, remove, inplane):
    T = random_poses(rng, 5)
    tCR = T[:, :3, 3] + rng.normal(scale=0.01, size=(5, 3)).astype(np.float32)
    kw = dict(multiview_type=mv_type, n_views=n_views, remove_TCO_rendering=remove,
              views_inplane_rotations=inplane)
    j = jmv.make_TCO_multiview(jnp.asarray(T), jnp.asarray(tCR), **kw)
    t = tmv.make_TCO_multiview(T_(T), T_(tCR), **kw)
    assert tuple(t.shape) == j.shape
    close(j, t, atol=ATOL, rtol=1e-6)
