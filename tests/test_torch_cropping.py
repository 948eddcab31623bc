"""Port vs JAX: antialiased box crops and DeepIM crop boxes.

`crop_images` is held against `jax.image.scale_and_translate` (through the
JAX package's `crop_images`) for boxes smaller than the output (upsampling:
plain bilinear) and larger (downsampling: the triangle filter widens).
Tolerance: atol 1e-5 on [0, 1] images (f32 sums of <= a few hundred
weighted terms, taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.ops import cropping as jcrop
from megapose6d_tpu.ops import se3 as jse3
from megapose6d_tpu_torch.ops import cropping as tcrop
from megapose6d_tpu_torch.ops._precision import pin_f32

pin_f32()
H, W = 60, 80
OUT = (24, 32)


def boxes_of_size(rng, n, scale):
    """Boxes whose width is `scale` times the output width."""
    w = OUT[1] * scale * rng.uniform(0.8, 1.2, size=n)
    h = OUT[0] * scale * rng.uniform(0.8, 1.2, size=n)
    cx = rng.uniform(-5, W + 5, size=n)
    cy = rng.uniform(-5, H + 5, size=n)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


@pytest.mark.parametrize("scale", [0.3, 1.0, 1.7, 2.6])
def test_crop_images(rng, scale):
    imgs = rng.uniform(size=(5, H, W, 3)).astype(np.float32)
    boxes = boxes_of_size(rng, 5, scale)
    j = jcrop.crop_images(jnp.asarray(imgs), jnp.asarray(boxes), OUT)
    t = tcrop.crop_images(torch.as_tensor(imgs), torch.as_tensor(boxes), OUT)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-5)


def test_crop_images_shared_image(rng):
    """One image broadcast over all boxes equals the repeated image."""
    img = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    boxes = np.concatenate([boxes_of_size(rng, 3, 0.5), boxes_of_size(rng, 3, 2.0)])
    j = jcrop.crop_images(jnp.asarray(np.repeat(img, 6, 0)), jnp.asarray(boxes), OUT)
    t = tcrop.crop_images(torch.as_tensor(img), torch.as_tensor(boxes), OUT)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-5)


def test_deepim_crops_robust(rng):
    B = 6
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    K = np.tile(np.asarray([[90.0, 0, 39.5], [0, 90.0, 29.5], [0, 0, 1]], np.float32), (B, 1, 1))
    R = np.asarray(jse3.rotmat_from_quat(jnp.asarray(rng.normal(size=(B, 4)).astype(np.float32))))
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, :3, :3] = R
    # Near (box larger than the output) and far (smaller) hypotheses.
    TCO[:, :3, 3] = np.stack([rng.normal(scale=0.03, size=B), rng.normal(scale=0.03, size=B),
                              np.linspace(0.15, 1.5, B)], -1)
    tCR = TCO[:, :3, 3] + rng.normal(scale=0.005, size=(B, 3)).astype(np.float32)
    pts = rng.normal(scale=0.04, size=(B, 40, 3)).astype(np.float32)
    obs_boxes = boxes_of_size(rng, B, 1.0)
    args = (obs_boxes, K, TCO, tCR, pts)
    bj, cj = jcrop.deepim_crops_robust(
        jnp.asarray(img), *map(jnp.asarray, args), output_size=OUT, lamb=1.4)
    bt, ct = tcrop.deepim_crops_robust(
        torch.as_tensor(img), *map(torch.as_tensor, args), output_size=OUT, lamb=1.4)
    np.testing.assert_allclose(np.asarray(bj), bt.numpy(), atol=1e-3, rtol=1e-5)  # pixels
    np.testing.assert_allclose(np.asarray(cj), ct.numpy(), atol=1e-4)
