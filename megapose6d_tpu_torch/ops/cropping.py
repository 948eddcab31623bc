"""DeepIM crop boxes and antialiased bilinear box crops.

Counterpart of `megapose6d_tpu/ops/cropping.py`. The JAX package crops
with `jax.image.scale_and_translate(method="linear")`, whose triangle
filter widens by the downsampling factor (antialiasing), so neither
`grid_sample` nor `interpolate` reproduces it. Here each box gets the same
separable weight matrices, applied with two batched matmuls.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import boxes_from_uv, masked_boxes_from_uv, project_points_robust

Tensor = torch.Tensor


def deepim_boxes(
    rend_center_uv: Tensor,
    obs_boxes: Tensor,
    rend_boxes: Tensor,
    lamb: float = 1.4,
    im_size: tuple[int, int] = (240, 320),
) -> Tensor:
    """Crop box `[B, 4]` around the projected reference point enclosing
    both boxes, with margin `lamb` and the aspect ratio of `im_size`."""
    w = max(im_size)
    h = min(im_size)
    r = w / h
    xc = rend_center_uv[..., 0]
    yc = rend_center_uv[..., 1]
    xs = torch.stack(
        [obs_boxes[..., 0], rend_boxes[..., 0], obs_boxes[..., 2], rend_boxes[..., 2]], -1
    )
    ys = torch.stack(
        [obs_boxes[..., 1], rend_boxes[..., 1], obs_boxes[..., 3], rend_boxes[..., 3]], -1
    )
    xdist = (xs - xc[..., None]).abs().amax(dim=-1)
    ydist = (ys - yc[..., None]).abs().amax(dim=-1)
    width = torch.maximum(xdist, ydist * r) * 2 * lamb
    height = torch.maximum(xdist / r, ydist) * 2 * lamb
    return torch.stack(
        [xc - width / 2, yc - height / 2, xc + width / 2, yc + height / 2], -1
    )


def _resample_weights(
    in_size: int, out_size: int, scale: Tensor, translation: Tensor
) -> Tensor:
    """Per-box weights `[B, in_size, out_size]` of the antialiased triangle
    filter, as `jax.image.scale_and_translate` builds them."""
    dev, dt = scale.device, scale.dtype
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = inv_scale.clamp_min(1.0)[:, None]
    sample_f = (
        (torch.arange(out_size, dtype=dt, device=dev) + 0.5) * inv_scale
        - translation[:, None] * inv_scale
        - 0.5
    )  # [B, out]
    x = (sample_f[:, None, :] - torch.arange(in_size, dtype=dt, device=dev)[None, :, None]).abs()
    weights = (1 - x / kernel_scale).clamp_min(0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def resize_bilinear(images: Tensor, size: tuple[int, int]) -> Tensor:
    """NHWC `images [B, h, w, C]` resized to `size` (H, W) as
    `jax.image.resize(..., method="bilinear")` resizes them: the triangle
    filter of `_resample_weights` at scale `H / h` and `W / w`, weights
    renormalised where the filter leaves the image."""
    _, h, w, _ = images.shape
    H, W = size
    one = torch.ones(1, dtype=images.dtype, device=images.device)
    wy = _resample_weights(h, H, one * (H / h), one * 0)[0]  # [h, H]
    wx = _resample_weights(w, W, one * (W / w), one * 0)[0]  # [w, W]
    x = torch.einsum("ih,bijc->bhjc", wy, images)
    return torch.einsum("jw,bhjc->bhwc", wx, x)


def crop_images(
    images: Tensor, boxes: Tensor, output_size: tuple[int, int], depth_dim: int | None = None
) -> Tensor:
    """Bilinear crop+resize of NHWC `images [B or 1, H, W, C]` to the boxes
    `[B, 4]` (x1, y1, x2, y2) -> `[B, out_h, out_w, C]`. One image is
    shared by all boxes when its batch is 1. With `depth_dim`, that
    channel is zeroed wherever the same resampling of its validity
    (`depth > 0`) is below 0.99, so no crop pixel mixes in missing depth."""
    _, H, W, C = images.shape
    out_h, out_w = output_size
    x1, y1, x2, y2 = boxes.unbind(-1)
    sx = out_w / (x2 - x1).clamp_min(1e-6)
    sy = out_h / (y2 - y1).clamp_min(1e-6)
    tx = sx * (0.5 - x1) - 0.5
    ty = sy * (0.5 - y1) - 0.5
    wy = _resample_weights(H, out_h, sy, ty)  # [B, H, out_h]
    wx = _resample_weights(W, out_w, sx, tx)  # [B, W, out_w]

    def resample(img: Tensor) -> Tensor:
        c = img.shape[-1]
        x = img.permute(0, 3, 1, 2).reshape(img.shape[0], c * H, W)
        x = (x @ wx).reshape(-1, c, H, out_w)  # [B, c, H, out_w]
        x = wy.transpose(1, 2)[:, None] @ x  # [B, c, out_h, out_w]
        return x.permute(0, 2, 3, 1)

    crops = resample(images)
    if depth_dim is not None:
        valid = (images[..., depth_dim : depth_dim + 1] > 0).to(images.dtype)
        mask = (resample(valid) >= 0.99).to(images.dtype)
        crops = torch.cat([crops[..., :depth_dim], crops[..., depth_dim : depth_dim + 1] * mask,
                           crops[..., depth_dim + 1 :]], dim=-1)
    return crops


def deepim_crops_robust(
    images: Tensor,
    obs_boxes: Tensor,
    K: Tensor,
    TCO_pred: Tensor,
    tCR: Tensor,
    O_vertices: Tensor,
    output_size: tuple[int, int],
    lamb: float = 1.4,
    points_valid: Tensor | None = None,
    depth_dim: int | None = None,
    return_crops: bool = True,
    im_size: tuple[int, int] | None = None,
) -> tuple[Tensor, Tensor | None]:
    """Crop the observation around the projected hypothesis. Returns
    (boxes `[B, 4]`, crops `[B, out_h, out_w, C]` or None). `im_size`
    stands in for the image size when `images` is None."""
    hw = im_size if images is None else tuple(images.shape[1:3])
    uv = project_points_robust(O_vertices, K, TCO_pred)
    if points_valid is not None:
        rend_boxes = masked_boxes_from_uv(uv, points_valid)
    else:
        rend_boxes = boxes_from_uv(uv)
    TCR = TCO_pred.clone()
    TCR[..., :3, 3] = tCR
    center = project_points_robust(torch.zeros_like(TCO_pred[..., :1, :3]), K, TCR)[..., 0, :]
    boxes = deepim_boxes(center, obs_boxes, rend_boxes, lamb=lamb, im_size=hw)
    crops = crop_images(images, boxes, output_size, depth_dim) if return_crops else None
    return boxes, crops
