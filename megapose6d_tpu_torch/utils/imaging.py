"""Pillow's image arithmetic in numpy, for the host-side augmentations.

The JAX package augments training images through PIL; the port's machines
may not have it, so these functions redo the same integer and float
operations, in the same order, and return the same arrays:

  - `resize` (Pillow's `Image.resize` with BILINEAR or BICUBIC, as
    `Resample.c` computes it): a separable convolution whose support
    grows with the downscale ratio, horizontal pass first, then vertical.
    On uint8 the coefficients are 22-bit fixed point and each pass rounds
    to uint8; on float32 they are float64 and each pass rounds to float32.
  - `resize_nearest` (NEAREST, `Geometry.c`'s scale-affine path): the
    source position of each output column and row is accumulated by
    repeated addition of the scale in float64.
  - `gaussian_blur` (`ImageFilter.GaussianBlur`): not a Gaussian but three
    passes of an extended box blur on each axis, in 24-bit fixed point.
  - `smooth` (`ImageFilter.SMOOTH`): a 3x3 float32 filter that keeps the
    border pixels.
  - `luma` (`convert("L")`, ITU-R 601-2 in 16-bit fixed point) and
    `blend` (`Image.blend`: float32, truncated toward zero, clipped when
    extrapolating).
"""

from __future__ import annotations

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, method: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`Resample.c`'s precompute_coeffs: per output pixel the first input
    pixel `xmin [out]`, the taps in use `xmax [out]` and the normalised
    float64 weights `[out, ksize]` (zero past `xmax`)."""
    fn, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; the clip at 0 follows.
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    # Summed tap by tap, as the C loop does.
    ww = np.zeros(out_size)
    for k in range(ksize):
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    return xmin, xmax, w


def _resample_axis(img: np.ndarray, axis: int, out_size: int, method: str) -> np.ndarray:
    """One pass of `Resample.c` along `axis` (0: rows, 1: columns)."""
    img = np.moveaxis(img, axis, 0)
    in_size = img.shape[0]
    xmin, xmax, w = _coeffs(in_size, out_size, method)
    ksize = w.shape[1]
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)
    bshape = (out_size,) + (1,) * (img.ndim - 1)
    if img.dtype == np.uint8:
        kk = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                      np.trunc(0.5 + w * (1 << _PRECISION_BITS))).astype(np.int64)
        acc = np.full((out_size,) + img.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
        for k in range(ksize):
            acc += img[idx[:, k]].astype(np.int64) * kk[:, k].reshape(bshape)
        out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    elif img.dtype == np.float32:
        acc = np.zeros((out_size,) + img.shape[1:], np.float64)
        for k in range(ksize):
            # Taps past xmax carry weight 0 and are not added in C: skip them.
            term = img[idx[:, k]].astype(np.float64) * w[:, k].reshape(bshape)
            acc = np.where((k < xmax).reshape(bshape), acc + term, acc)
        out = acc.astype(np.float32)
    else:
        raise ValueError(f"resize of {img.dtype} images is not supported")
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: tuple[int, int], method: str = "bilinear") -> np.ndarray:
    """`Image.fromarray(img).resize((w, h), method)` for `size = (h, w)`:
    uint8 `[H, W]` / `[H, W, C]` or float32 `[H, W]`."""
    out_h, out_w = size
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    if w != out_w:
        img = _resample_axis(img, 1, out_w, method)
    if h != out_h:
        img = _resample_axis(img, 0, out_h, method)
    return img


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.where(pos < 0.0, -1, pos.astype(np.int64))


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`Image.fromarray(img).resize((w, h), NEAREST)` for `size = (h, w)`."""
    h, w = img.shape[:2]
    if (h, w) == tuple(size):
        return img.copy()
    ys, xs = _nearest_index(h, size[0]), _nearest_index(w, size[1])
    if (ys < 0).any() or (ys >= h).any() or (xs < 0).any() or (xs >= w).any():
        raise ValueError("nearest resize reads outside the image")
    return img[ys][:, xs]


def _box_radius(radius: float, passes: int) -> np.float32:
    """`BoxBlur.c`'s _gaussian_blur_radius, in C's float and double."""
    f = np.float32
    sigma2 = f(f(f(radius) * f(radius)) / f(passes))
    L = f(np.sqrt(12.0 * float(sigma2) + 1.0))
    l = f(np.floor((float(L) - 1.0) / 2.0))
    a = f((2 * float(l) + 1) * (float(l) * (float(l) + 1) - 3 * float(sigma2)))
    a = f(float(a) / (6 * (float(sigma2) - (float(l) + 1) * (float(l) + 1))))
    return f(l + a)


def _box_blur_axis(img: np.ndarray, axis: int, radius: np.float32) -> np.ndarray:
    """One `ImagingLineBoxBlur` pass along `axis` of a uint8 image: the
    window of `2r + 1` edge-clamped pixels weighted `ww`, its two outer
    neighbours `fw`, in 24-bit fixed point (C's UINT32, which the sums fit:
    at most 255 * 2^24 + 2^23)."""
    r = int(radius)
    ww = int(np.float32(16777216.0) / np.float32(radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (r * 2 + 1) * ww) // 2
    x = np.moveaxis(img, axis, 0)
    n = x.shape[0]
    pad = np.concatenate([np.repeat(x[:1], r + 1, 0), x, np.repeat(x[-1:], r + 1, 0)]).astype(np.int32)
    csum = np.cumsum(pad, axis=0, dtype=np.int32)
    # pad[x + 1 .. x + 2r + 1]: the window of output x, from the running sum.
    win = csum[2 * r + 1 : 2 * r + 1 + n] - csum[:n]
    bulk = win.astype(np.uint32) * np.uint32(ww) + (pad[:n] + pad[2 * r + 2 : 2 * r + 2 + n]).astype(np.uint32) * np.uint32(fw)
    out = ((bulk + np.uint32(1 << 23)) >> np.uint32(24)).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """`Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius))` for
    uint8 `[H, W]` / `[H, W, C]`. Pillow refuses float images ("image has
    wrong mode"), and so does this."""
    if img.dtype != np.uint8:
        raise ValueError("image has wrong mode")
    if radius == 0:
        return img.copy()
    box = _box_radius(radius, passes)
    for axis in (1, 0):
        for _ in range(passes):
            img = _box_blur_axis(img, axis, box)
    return img


def _clip8(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.0, 0, np.where(x >= 255.0, 255, np.trunc(np.clip(x, 0, 255)))).astype(np.uint8)


def smooth(img: np.ndarray) -> np.ndarray:
    """`ImageFilter.SMOOTH` (3x3 kernel 1 1 1 / 1 5 1 / 1 1 1 over 13) of a
    uint8 `[H, W, 3]` image; the border rows and columns are copied."""
    f = np.float32
    k1, k5 = f(1) / f(13), f(5) / f(13)
    x = img.astype(np.float32)
    out = img.copy()
    if img.shape[0] < 3 or img.shape[1] < 3:
        return out

    def row(r: np.ndarray, k: tuple) -> np.ndarray:  # KERNEL1x3, left to right
        return r[:, :-2] * k[0] + r[:, 1:-1] * k[1] + r[:, 2:] * k[2]

    ss = np.full(x[1:-1, 1:-1].shape, f(0.5), np.float32)
    ss = ss + row(x[2:], (k1, k1, k1))
    ss = ss + row(x[1:-1], (k1, k5, k1))
    ss = ss + row(x[:-2], (k1, k1, k1))
    out[1:-1, 1:-1] = _clip8(ss)
    return out


def luma(img: np.ndarray) -> np.ndarray:
    """`convert("L")` of uint8 RGB: `(19595 R + 38470 G + 7471 B + 0x8000) >> 16`."""
    x = img.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def blend(degenerate: np.ndarray, img: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(degenerate, img, alpha)` of uint8 images: `d + alpha (i - d)`
    in float32, truncated; clipped to [0, 255] when extrapolating."""
    a = np.float32(alpha)
    if a == 0.0:
        return degenerate.copy()
    if a == 1.0:
        return img.copy()
    d = degenerate.astype(np.int32)
    v = d.astype(np.float32) + a * (img.astype(np.int32) - d).astype(np.float32)
    if 0.0 <= a <= 1.0:
        return np.trunc(v).astype(np.uint8)
    return _clip8(v)
