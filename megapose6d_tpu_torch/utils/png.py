"""PNG decoding and encoding with numpy and the standard library's zlib.

The JAX package decodes images through libpng (`native/decode.cc`) or
PIL and writes them through PIL; the port's machines may have neither, so
it reads the PNGs of the BOP datasets itself: non-interlaced grey, RGB and
RGBA at 8 bits and grey at 16 bits, with all five row filters. Anything
else is refused. `encode_png` writes 8-bit grey and RGB and 16-bit grey
(BOP depth in millimetres), every row with the Up filter.

Unfiltering is vectorised. A pixel's byte depends only on its left, upper
and upper-left neighbours, so the image is reconstructed one anti-diagonal
(y + x = const) at a time: H + W numpy steps, each over one diagonal, with
every row applying its own filter type.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> channels.
_FORMATS = {(0, 8): 1, (0, 16): 1, (2, 8): 3, (6, 8): 4}


def read_png(path: str | Path) -> np.ndarray:
    """Decode the PNG file at `path`; see `decode_png`."""
    return decode_png(Path(path).read_bytes())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """`[H, W]` uint8 or uint16 (grey) or `[H, W, 3]` uint8 (RGB) -> PNG
    bytes that `decode_png` (and PIL) read back as the same array."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        colour, depth = 0, img.dtype.itemsize * 8
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        colour, depth = 2, 8
    else:
        raise ValueError(f"encode_png takes [H, W] uint8/uint16 or [H, W, 3] uint8, not {img.shape} {img.dtype}")
    H, W = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8).reshape(H, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # the Up filter, modulo 256
    raw = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray) -> Path:
    """Encode `img` (see `encode_png`) to the file `path`."""
    path = Path(path)
    path.write_bytes(encode_png(img))
    return path


def decode_png(data: bytes, unfilter_rows=None) -> np.ndarray:
    """PNG bytes -> `[H, W]` (grey) or `[H, W, C]` (RGB, RGBA) array,
    `uint8`, or `uint16` for 16-bit grey. The same arrays as
    `np.asarray(PIL.Image.open(...))`. `unfilter_rows` replaces `unfilter`
    (`native.unfilter`, the same bytes in C)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    W, H, depth, colour, compression, filt, interlace = header
    if interlace != 0:
        raise ValueError("interlaced PNGs are not supported")
    if (colour, depth) not in _FORMATS or compression != 0 or filt != 0:
        raise ValueError(
            f"unsupported PNG: colour type {colour}, bit depth {depth} "
            "(grey, RGB, RGBA at 8 bits and grey at 16 bits are)"
        )
    channels = _FORMATS[(colour, depth)]
    bpp = channels * depth // 8  # bytes per pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError("PNG data has the wrong size")
    raw = raw.reshape(H, 1 + W * bpp)
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG row filter {int(ftype.max())}")
    pixels = (unfilter_rows or unfilter)(raw[:, 1:].reshape(H, W, bpp), ftype)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    pixels = pixels.reshape(H, W, channels)
    return pixels[..., 0] if channels == 1 else pixels


def unfilter(filtered: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters. `filtered [H, W, bpp]` uint8, `ftype [H]`
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) -> `[H, W, bpp]` uint8."""
    H, W, bpp = filtered.shape
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up only: one vectorised step per row.
        out = filtered.copy()
        for y in range(H):
            if ftype[y] == 1:
                out[y] = np.cumsum(out[y], axis=0, dtype=np.uint8)  # wraps mod 256
            elif ftype[y] == 2 and y > 0:
                out[y] += out[y - 1]
        return out
    # Reconstructed pixels, flat, with a zero row above and a zero column
    # to the left: pixel (y, x) lives at q = (y + 1) * (W + 1) + x + 1.
    out = np.zeros(((H + 1) * (W + 1), bpp), np.int32)
    y, x = np.divmod(np.arange(H * W), W)
    order = np.argsort(y + x, kind="stable")  # anti-diagonals, in turn
    y, x = y[order], x[order]
    q = (y + 1) * (W + 1) + x + 1
    f = filtered.reshape(H * W, bpp)[order].astype(np.int32)
    kind = ftype[y][:, None]
    is_sub, is_up, is_avg, is_paeth = (kind == k for k in (1, 2, 3, 4))
    d = np.arange(H + W - 1)
    ends = np.cumsum(np.minimum(d, H - 1) - np.maximum(d - W + 1, 0) + 1)  # diagonal lengths
    s = 0
    for e in ends:
        qd = q[s:e]
        a, b, c = out[qd - 1], out[qd - (W + 1)], out[qd - (W + 2)]  # left, up, up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(is_paeth[s:e], paeth, np.where(is_avg[s:e], (a + b) >> 1, 0))
        pred = np.where(is_up[s:e], b, np.where(is_sub[s:e], a, pred))
        out[qd] = (f[s:e] + pred) & 0xFF
        s = e
    return out.reshape(H + 1, W + 1, bpp)[1:, 1:].astype(np.uint8)
