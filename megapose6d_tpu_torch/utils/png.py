"""PNG decoding and encoding with numpy and the standard library's zlib.

The JAX package decodes images through libpng (`native/decode.cc`) or
PIL and writes them through PIL; the port's machines may have neither, so
it reads PNGs itself, to the arrays libpng gives as `decode.cc` configures
it (`decode_png`): every colour type at 1 to 8 bits and grey at 16,
Adam7-interlaced or not, with all five row filters; palettes expanded to
RGB, 1/2/4-bit grey scaled to 8 bits and a tRNS chunk turned into an alpha
channel. 16-bit colour is refused, as `decode.cc` refuses it, and so is
what libpng refuses as malformed. `encode_png` writes 8-bit grey and RGB
and 16-bit grey (BOP depth in millimetres), every row with the Up filter.

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
# Colour type -> (samples per pixel, the bit depths PNG allows for it):
# grey, RGB, palette indices, grey with alpha, RGBA.
_COLOUR = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: the (x0, y0, dx, dy) of each of the seven passes.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_MAX_SIDE = 1_000_000  # libpng's default limit on the width and the height


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


def _chunks(data: bytes) -> tuple[tuple, bytes | None, bytes | None, bytes]:
    """IHDR's fields, the palette and tRNS bodies that apply (else None)
    and the image data, read as libpng reads a file up to the end of its
    first run of IDAT chunks (`png_read_info`, then the rows; nothing after
    the run is read). A critical chunk with a bad CRC, an unknown critical
    chunk, a second IHDR or PLTE, a palette image without a PLTE before its
    data and a PLTE libpng cannot use raise ValueError; an ancillary chunk
    with a bad CRC, a misplaced or invalid tRNS and a second tRNS are
    ignored, as libpng ignores them."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, plte, trns, idat = 8, None, None, None, []
    seen_plte = seen_trns = False
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        if idat and kind != b"IDAT":
            break  # the end of the image data
        body, crc = data[pos + 8 : pos + 8 + n], data[pos + 8 + n : pos + 12 + n]
        pos += 12 + n
        if len(crc) < 4:
            raise ValueError(f"PNG chunk {kind!r} cut short")
        critical = not kind[0] & 0x20
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            if critical:
                raise ValueError(f"PNG chunk {kind!r}: CRC error")
            continue
        if header is None and kind != b"IHDR":
            raise ValueError("PNG without IHDR first")
        if kind == b"IHDR":
            if header is not None or n != 13:
                raise ValueError("PNG with a bad IHDR")
            header = struct.unpack(">IIBBBBB", body)
            W, H, depth, colour, compression, filt, interlace = header
            if (colour not in _COLOUR or depth not in _COLOUR[colour][1] or compression or filt or interlace > 1
                    or not 0 < W <= _MAX_SIDE or not 0 < H <= _MAX_SIDE):
                raise ValueError(f"PNG with an invalid IHDR {header}")
        elif kind == b"PLTE":
            if seen_plte:
                raise ValueError("PNG with two PLTE chunks")
            seen_plte = True
            if colour & 2:  # a grey image ignores its PLTE
                if n == 0 or (colour == 3 and (n % 3 or n > 768)):
                    raise ValueError(f"PNG with an invalid palette of {n} bytes")
                if n % 3 == 0 and n <= 768:  # else RGB's suggested palette, ignored
                    plte = body[: 3 * (1 << depth)] if colour == 3 else body
                    trns = None  # a tRNS before the PLTE is cancelled
        elif kind == b"tRNS":
            valid = {0: n == 2, 2: n == 6, 3: plte is not None and 0 < n <= len(plte) // 3}.get(colour, False)
            if valid and not seen_trns:
                trns, seen_trns = body, True
        elif kind == b"IDAT":
            if colour == 3 and plte is None:
                raise ValueError("PNG palette image without a PLTE before its data")
            idat.append(body)
        elif critical:
            raise ValueError(f"PNG with an unexpected critical chunk {kind!r}")
    if not idat:
        raise ValueError("PNG without IHDR or IDAT")
    return header, plte, trns, b"".join(idat)


def _unpack(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows `[h, rowbytes]` -> samples `[h, w, channels]`
    (uint16 at 16 bits; sub-byte samples MSB first, unscaled)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    if depth == 8:
        return rows.reshape(h, w, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def decode_png(data: bytes, unfilter_rows=None) -> np.ndarray:
    """PNG bytes -> the array libpng gives as `decode.cc` configures it:
    `[H, W]` grey, `[H, W, 2]` grey with alpha, `[H, W, 3]` RGB or
    `[H, W, 4]` RGBA, `uint8`, or `[H, W]` `uint16` for 16-bit grey.
    Palettes are expanded to RGB (an index past the palette's end is black),
    1/2/4-bit grey is scaled to 8 bits, and a tRNS chunk adds an alpha
    channel (0 where a pixel equals its colour, for palettes its entries
    and 255 past them); at 16 bits tRNS is not applied. Adam7 images are
    de-interlaced. `unfilter_rows` replaces `unfilter` (`native.unfilter`,
    the same bytes in C); a sub-byte row is unfiltered byte by byte."""
    (W, H, depth, colour, _, _, interlace), plte, trns, stream = _chunks(data)
    if depth == 16 and colour != 0:
        raise ValueError(f"unsupported PNG: colour type {colour} at 16 bits (grey is read at 16 bits)")
    try:
        raw = np.frombuffer(zlib.decompress(stream), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    channels = _COLOUR[colour][0]
    bits = channels * depth
    unit = max(1, bits // 8)  # the filters' byte distance
    samples = np.empty((H, W, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if w <= 0 or h <= 0:
            continue  # an empty pass has no rows
        rowbytes = -(-w * bits // 8)
        if raw.size < pos + h * (1 + rowbytes):
            raise ValueError("PNG image data cut short")
        rows = raw[pos : pos + h * (1 + rowbytes)].reshape(h, 1 + rowbytes)
        pos += h * (1 + rowbytes)
        ftype = rows[:, 0]
        if (ftype > 4).any():
            raise ValueError(f"bad PNG row filter {int(ftype.max())}")
        rows = (unfilter_rows or unfilter)(rows[:, 1:].reshape(h, rowbytes // unit, unit), ftype)
        samples[y0::dy, x0::dx] = _unpack(rows.reshape(h, rowbytes), w, channels, depth)
    if depth == 16:
        return samples[..., 0]
    alpha = None
    if trns is not None:
        if colour == 3:
            table = np.full(256, 255, np.uint8)
            table[: len(trns)] = np.frombuffer(trns, np.uint8)
            alpha = table[samples[..., 0]]
        else:  # the tRNS colour, cut to the bit depth as libpng cuts it
            key = np.array(struct.unpack(f">{channels}H", trns)) & ((1 << depth) - 1)
            alpha = np.where((samples == key).all(-1), 0, 255).astype(np.uint8)
    if colour == 3:
        palette = np.zeros((256, 3), np.uint8)
        palette[: len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        samples = palette[samples[..., 0]]
    elif depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if alpha is not None:
        samples = np.concatenate([samples, alpha[..., None]], -1)
    return samples[..., 0] if samples.shape[-1] == 1 else samples


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
