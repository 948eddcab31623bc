"""Baseline TIFF decoding with numpy and the standard library's zlib.

The JAX package reads TIFF through PIL (BOP's ITODD ships its frames as
`gray/*.tif`); the port's machines may have no PIL, so it reads them itself:
the first page of a baseline TIFF in either byte order, in strips or tiles,
uncompressed, PackBits, LZW or Deflate (codes 8 and 32946), with the
horizontal predictor (2) where libtiff applies it (LZW and Deflate). It
returns 8-bit grey as `[H, W]` uint8 (WhiteIsZero inverted, as PIL's
`L;I`), 16-bit grey (BlackIsZero) as `[H, W]` uint16 in native byte order,
and 8-bit RGB as `[H, W, 3]` uint8: the values of
`np.asarray(PIL.Image.open(...))`. Anything else raises ValueError.

LZW and PackBits decode byte by byte, which numpy cannot vectorise:
`lzw_decode` and `packbits_decode` here are the plain twins of
`native/tiff.cc`, which `decode_tiff` takes in their place when it builds.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable

import numpy as np

# Tags.
_WIDTH, _HEIGHT, _BITS, _COMPRESSION, _PHOTOMETRIC, _FILL_ORDER = 256, 257, 258, 259, 262, 266
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES, _PLANAR = 273, 277, 278, 279, 284
_PREDICTOR, _TILE_W, _TILE_H, _TILE_OFFSETS, _TILE_BYTES, _EXTRA, _SAMPLE_FORMAT = 317, 322, 323, 324, 325, 338, 339
# Field type -> (struct code, size).
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          16: ("Q", 8)}
_NONE, _LZW, _PACKBITS, _DEFLATE = 1, 5, 32773, (8, 32946)
_LZW_TABLE = 5119  # libtiff's CSIZE: the codes past 4095 it tolerates at 12 bits

StripDecoder = Callable[[bytes, int], bytes]


def _fields(data: bytes) -> tuple[str, dict[int, tuple]]:
    if data[:4] == b"II*\0":
        order = "<"
    elif data[:4] == b"MM\0*":
        order = ">"
    else:
        raise ValueError("not a TIFF file (or a BigTIFF, which is not supported)")
    (ifd,) = struct.unpack(order + "I", data[4:8])
    if ifd + 2 > len(data):
        raise ValueError("TIFF: the first directory lies past the end of the file")
    (n,) = struct.unpack(order + "H", data[ifd : ifd + 2])
    fields = {}
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(data):
            raise ValueError("TIFF: truncated directory")
        tag, kind, count = struct.unpack(order + "HHI", data[at : at + 8])
        if kind not in _TYPES:
            continue  # rationals, floats: no tag read here has them
        code, size = _TYPES[kind]
        where = at + 8 if size * count <= 4 else struct.unpack(order + "I", data[at + 8 : at + 12])[0]
        if where + size * count > len(data):
            raise ValueError(f"TIFF: tag {tag} lies past the end of the file")
        fields[tag] = struct.unpack(f"{order}{count}{code}", data[where : where + size * count])
    return order, fields


def decode_tiff(data: bytes, lzw: StripDecoder | None = None, packbits: StripDecoder | None = None) -> np.ndarray:
    """TIFF bytes -> `[H, W]` uint8 / uint16 or `[H, W, 3]` uint8 (see the
    module's docstring). `lzw` and `packbits` replace `lzw_decode` and
    `packbits_decode` (`native`'s, the same bytes in C++)."""
    order, f = _fields(bytes(data))

    def one(tag: int, default=None):
        if tag not in f:
            if default is None:
                raise ValueError(f"TIFF: required tag {tag} is missing")
            return default
        return f[tag][0]

    W, H = one(_WIDTH), one(_HEIGHT)
    spp = one(_SAMPLES, 1)
    bits = f.get(_BITS, (1,) * spp)
    photometric = one(_PHOTOMETRIC)
    compression = one(_COMPRESSION, 1)
    predictor = one(_PREDICTOR, 1)
    if len(set(bits)) != 1 or len(bits) != spp:
        raise ValueError(f"TIFF: unsupported bits per sample {bits}")
    depth = bits[0]
    layout = (spp, depth, photometric)
    if layout not in ((1, 8, 0), (1, 8, 1), (1, 16, 1), (3, 8, 2)):
        raise ValueError(f"TIFF: unsupported samples / bits / photometric {layout} "
                         "(8-bit grey, 16-bit grey BlackIsZero and 8-bit RGB are)")
    if f.get(_SAMPLE_FORMAT, (1,))[0] != 1 or one(_FILL_ORDER, 1) != 1 or _EXTRA in f:
        raise ValueError("TIFF: unsupported sample format, fill order or extra samples")
    if spp > 1 and one(_PLANAR, 1) != 1:
        raise ValueError("TIFF: planar RGB is not supported")
    if compression not in (_NONE, _LZW, _PACKBITS, *_DEFLATE):
        raise ValueError(f"TIFF: unsupported compression {compression}")
    if predictor not in (1, 2):
        raise ValueError(f"TIFF: unsupported predictor {predictor}")
    if W == 0 or H == 0:
        raise ValueError("TIFF: empty image")

    if _TILE_OFFSETS in f:
        bw, bh = one(_TILE_W), one(_TILE_H)
        offsets, counts = f[_TILE_OFFSETS], f.get(_TILE_BYTES)
        grid = (-(-H // bh), -(-W // bw))
    else:
        bw, bh = W, min(one(_ROWS_PER_STRIP, 2**32 - 1), H)
        offsets, counts = f[_STRIP_OFFSETS], f.get(_STRIP_BYTES)
        grid = (-(-H // bh), 1)
    if len(offsets) != grid[0] * grid[1]:
        raise ValueError(f"TIFF: {len(offsets)} strips or tiles, {grid[0] * grid[1]} expected")
    if counts is None:
        if compression != _NONE:
            raise ValueError("TIFF: compressed strips without byte counts")
        counts = [bh * bw * spp * depth // 8] * len(offsets)

    dtype = np.dtype(order + "u2") if depth == 16 else np.dtype(np.uint8)
    out = np.zeros((grid[0] * bh, grid[1] * bw, spp), dtype)
    for i, (at, n) in enumerate(zip(offsets, counts)):
        gy, gx = divmod(i, grid[1])
        rows = bh if _TILE_OFFSETS in f else min(bh, H - gy * bh)  # a tile is whole, the last strip short
        size = rows * bw * spp * depth // 8
        raw = bytes(data[at : at + n])
        if compression == _LZW:
            if raw[:1] == b"\0" and len(raw) > 1 and raw[1] & 1:
                raise ValueError("TIFF: old-style LZW is not supported")
            raw = (lzw or lzw_decode)(raw, size)
        elif compression == _PACKBITS:
            raw = (packbits or packbits_decode)(raw, size)
        elif compression in _DEFLATE:
            try:
                raw = zlib.decompressobj().decompress(raw, size)
            except zlib.error as e:
                raise ValueError(f"TIFF: corrupt Deflate data ({e})") from None
        if len(raw) < size:
            raise ValueError("TIFF: a strip or tile holds too little data (truncated or corrupt file)")
        block = np.frombuffer(raw[:size], dtype).reshape(rows, bw, spp)
        if predictor == 2 and compression != _NONE and compression != _PACKBITS:
            block = np.cumsum(block.astype(np.uint16 if depth == 8 else np.uint32), axis=1).astype(dtype)
        out[gy * bh : gy * bh + rows, gx * bw : (gx + 1) * bw] = block
    img = out[:H, :W]
    if depth == 16:
        img = img.astype(np.uint16)
    if photometric == 0:
        img = 255 - img
    return np.ascontiguousarray(img[..., 0] if spp == 1 else img)


def packbits_decode(data: bytes, size: int) -> bytes:
    """PackBits (Apple's run-length code, TIFF compression 32773), up to
    `size` bytes of output."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < size:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i : i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += bytes([data[i]]) * (257 - c)
            i += 1
    return bytes(out[:size])


def lzw_decode(data: bytes, size: int) -> bytes:
    """TIFF's LZW (compression 5: codes MSB first from 9 to 12 bits, the
    width growing one code early, 256 clears and 257 ends), up to `size`
    bytes of output. Raises ValueError on a code not yet defined."""
    table: list[bytes] = []
    out = bytearray()
    prev = b""
    acc = nacc = pos = 0
    nbits = 9
    n = len(data)

    def reset():
        table.clear()
        table.extend(bytes([i]) for i in range(256))
        table.extend((b"", b""))

    reset()
    while len(out) < size:
        while nacc < nbits and pos < n:
            acc = ((acc << 8) | data[pos]) & 0xFFFFFFFF
            pos += 1
            nacc += 8
        if nacc < nbits:
            break
        code = (acc >> (nacc - nbits)) & ((1 << nbits) - 1)
        nacc -= nbits
        if code == 257:
            break
        if code == 256:
            reset()
            nbits, prev = 9, b""
            continue
        if code < len(table) and (code < 256 or code > 257):
            entry = table[code]
            if prev:
                table.append(prev + entry[:1])
        elif code == len(table) and prev:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("TIFF: corrupt LZW data")
        if len(table) > _LZW_TABLE:
            raise ValueError("TIFF: corrupt LZW data (the table overflows)")
        out += entry
        prev = entry
        nbits = 12 if len(table) >= 2047 else 11 if len(table) >= 1023 else 10 if len(table) >= 511 else 9
    return bytes(out[:size])
