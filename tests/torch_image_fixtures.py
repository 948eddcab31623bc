"""The JPEG and TIFF fixtures of `tests/data/torch_images/`, and the encoders
the tests use to make more.

Run as a script to regenerate the directory and its `hashes.json` from the
committed synthdemo frames (`runs/ar_dr/synthdemo`):

    python -m tests.torch_image_fixtures

It is not collected by pytest. PIL writes what it can (4:4:4, 4:2:2 and
4:2:0, progressive, restart markers, optimised tables, EXIF, Adobe RGB;
TIFF in little-endian order, with LZW, PackBits or Deflate and the
predictor). Arithmetic-coded JPEGs come from libjpeg's own compressor
through `tests/torch_libjpeg_writer.cc` (`libjpeg_jpeg`; built with g++
where libjpeg's headers are installed). What neither writes comes from the
two small encoders here:
`encode_jpeg`, a baseline / extended sequential Huffman encoder with any
sampling factors (4:4:0, 4:1:1, mixed), restart intervals and 16-bit
quantisation tables; and `encode_tiff`, a TIFF writer in either byte order,
in strips or tiles, with any of the four compressions, the predictor and
WhiteIsZero. Their files are valid: PIL and libjpeg read them.

The PNGs (`png/`, one small image per colour type, bit depth, tRNS and
interlace that libpng reads, and `textures/`, the committed synthdemo
textures as Adam7, tRNS, RGBA and palette PNGs beside a JPEG copy) come
from `encode_png_any`, a writer of every PNG layout with every row filter.

`hashes.json` maps each file to `array_hash` of its reference decode: the
JAX package's native decoder (libpng) for a PNG, since PIL returns a
palette image's indices, and PIL's decode for a JPEG or TIFF (the same
arrays as the JAX package's native decoder, where it decodes); the tests
and `chip_smoke.py` hold the port's decode to it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import io
import json
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests/data/torch_images"
SYNTHDEMO = ROOT / "runs/ar_dr/synthdemo"
ITODD_SCENE = "000000"  # the scene whose frames are written as grey TIFFs
TEXTURES = ROOT / "runs/ar_baseline/synthdemo/models"  # obj_000001.png, obj_000002.png (192x192 RGB)
TEXTURE_FORMATS = ("adam7.png", "trns.png", "rgba.png", "palette.png", "q95.jpg")  # textures/<obj>_<format>


def array_hash(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype (native order), shape and bytes."""
    a = np.ascontiguousarray(a, a.dtype.newbyteorder("="))
    return hashlib.sha256(f"{a.dtype.name}{list(a.shape)}".encode() + a.tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# JPEG: a baseline / extended sequential Huffman encoder
# ---------------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
    54, 47, 55, 62, 63])
# ITU T.81 Annex K: quantisation tables (natural order) and Huffman tables.
Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29,
    51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121,
    120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
Q_CHROMA = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5
                    + [47, 66] + [99] * 38)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738"
    "393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4"
    "a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a3536"
    "3738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92939495969798999a"
    "a2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _codes(table) -> dict[int, tuple[int, int]]:
    """Canonical Huffman codes: symbol -> (code, length)."""
    bits, vals = table
    out, code, k = {}, 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


def _quality_table(base: np.ndarray, quality: int, limit: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of a base table."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, limit)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


class _Bits:
    """MSB-first bits; `stuff` writes a 0 after each 0xFF (JPEG)."""

    def __init__(self, stuff: bool = True):
        self.out = bytearray()
        self.acc = self.n = 0
        self.stuff = stuff

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF and self.stuff:
                self.out.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def align(self, ones: bool = True) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1 if ones else 0, 8 - self.n)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 90, sampling=None, restart: int = 0, sof: int = 0xC0,
                q16: bool = False, rgb: bool = False, jfif: bool = True, app1: bytes | None = None) -> bytes:
    """`[H, W]` or `[H, W, 3]` uint8 -> a sequential Huffman JPEG (SOF0,
    or `sof=0xC1` for extended) with the Annex K Huffman tables.
    `sampling`: (h, v) per component (default 1x1 each); `restart`: MCUs
    per restart interval; `q16`: 16-bit quantisation tables (values up to
    32767, so `quality` below 25 stays unclipped); `rgb`: store R, G, B
    unconverted, marked by Adobe's transform 0 (or, with `jfif=False`
    and no Adobe marker, by the component ids 'R', 'G', 'B' alone, when
    `rgb="ids"`)."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    if img.ndim == 2:
        planes = [img.astype(np.float64)]
    elif rgb:
        planes = [img[..., c].astype(np.float64) for c in range(3)]
    else:
        r, g, b = (img[..., c].astype(np.float64) for c in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b, -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    nc = len(planes)
    sampling = list(sampling or [(1, 1)] * nc)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    limit = 32767 if q16 else 255
    qts = [_quality_table(Q_LUMA, quality, limit), _quality_table(Q_CHROMA, quality, limit)]
    dct = _dct_matrix()
    blocks = []
    for c, (plane, (h, v)) in enumerate(zip(planes, sampling)):
        full = np.pad(plane, ((0, mcuy * 8 * vmax - H), (0, mcux * 8 * hmax - W)), mode="edge")
        fy, fx = vmax // v, hmax // h
        small = full.reshape(full.shape[0] // fy, fy, full.shape[1] // fx, fx).mean((1, 3)) - 128
        by, bx = small.shape[0] // 8, small.shape[1] // 8
        b = small.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
        coef = dct @ b @ dct.T
        blocks.append(np.round(coef / qts[min(c, 1)].reshape(8, 8)).astype(np.int64).reshape(by, bx, 64)[..., ZIGZAG])
    huff = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]

    bits = _Bits()
    pred = [0] * nc
    interleaved = nc > 1
    order = [(my, mx) for my in range(mcuy if interleaved else -(-H // 8))
             for mx in range(mcux if interleaved else -(-W // 8))]
    out = bytearray()
    rst = 0
    for m, (my, mx) in enumerate(order):
        if restart and m and m % restart == 0:
            bits.align()
            out += bits.out + bytes([0xFF, 0xD0 + rst])
            bits.out = bytearray()
            rst = (rst + 1) % 8
            pred = [0] * nc
        for c, (h, v) in enumerate(sampling):
            hh, vv = (h, v) if interleaved else (1, 1)
            dc_codes, ac_codes = huff[min(c, 1)]
            for y in range(vv):
                for x in range(hh):
                    blk = blocks[c][my * vv + y, mx * hh + x]
                    diff = int(blk[0]) - pred[c]
                    pred[c] = int(blk[0])
                    size = abs(diff).bit_length()
                    bits.put(*dc_codes[size])
                    if size:
                        bits.put(diff if diff > 0 else diff + (1 << size) - 1, size)
                    run = 0
                    for k in range(1, 64):
                        a = int(blk[k])
                        if a == 0:
                            run += 1
                            continue
                        while run > 15:
                            bits.put(*ac_codes[0xF0])
                            run -= 16
                        size = abs(a).bit_length()
                        bits.put(*ac_codes[(run << 4) | size])
                        bits.put(a if a > 0 else a + (1 << size) - 1, size)
                        run = 0
                    if run:
                        bits.put(*ac_codes[0x00])
    bits.align()
    out += bits.out

    ids = [ord("R"), ord("G"), ord("B")] if rgb == "ids" else list(range(1, nc + 1))
    head = bytearray(b"\xff\xd8")
    if jfif:
        head += _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if app1 is not None:
        head += _segment(0xE1, app1)
    if rgb is True:
        head += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    for t, q in enumerate(qts[: min(nc, 2)]):
        head += _segment(0xDB, bytes([(16 if q16 else 0) | t]) + (
            b"".join(struct.pack(">H", int(x)) for x in q[ZIGZAG]) if q16 else bytes(q[ZIGZAG].astype(np.uint8))))
    head += _segment(sof, struct.pack(">BHHB", 8, H, W, nc) + b"".join(
        bytes([ids[c], (h << 4) | v, min(c, 1)]) for c, (h, v) in enumerate(sampling)))
    for t, (dc, ac) in enumerate(((DC_LUMA, AC_LUMA), (DC_CHROMA, AC_CHROMA))[: min(nc, 2)]):
        head += _segment(0xC4, bytes([t]) + bytes(dc[0]) + bytes(dc[1]))
        head += _segment(0xC4, bytes([0x10 | t]) + bytes(ac[0]) + bytes(ac[1]))
    if restart:
        head += _segment(0xDD, struct.pack(">H", restart))
    head += _segment(0xDA, bytes([nc]) + b"".join(bytes([ids[c], min(c, 1) * 0x11]) for c in range(nc))
                     + bytes([0, 63, 0]))
    return bytes(head + out + b"\xff\xd9")


@functools.cache
def _libjpeg_writer() -> ctypes.CDLL | None:
    """`tests/torch_libjpeg_writer.cc`, built into a temporary directory;
    None where g++ or libjpeg's headers are missing."""
    out = Path(tempfile.mkdtemp(prefix="libjpeg_writer_")) / "writer.so"
    cmd = ["g++", "-O2", "-shared", "-fPIC", str(ROOT / "tests/torch_libjpeg_writer.cc"), "-o", str(out), "-ljpeg"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    lib = ctypes.CDLL(str(out))
    u8p, ip = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)
    lib.mp_write_jpeg.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ip, ip, ctypes.POINTER(u8p),
                                  ctypes.POINTER(ctypes.c_ulong)]
    lib.mp_write_jpeg.restype = ctypes.c_int
    lib.mp_free.argtypes = [u8p]
    lib.mp_free.restype = None
    return lib


def libjpeg_available() -> bool:
    return _libjpeg_writer() is not None


def libjpeg_jpeg(img: np.ndarray, quality: int = 90, arith: bool = True, progressive: bool = False,
                 restart_rows: int = 0, sampling=None, dac: tuple[int, int, int] | None = None) -> bytes:
    """`[H, W]` or `[H, W, 3]` uint8 through libjpeg's compressor:
    arithmetic coding (`arith`), its conditioning (`dac` = (L, U, K) for
    every table), libjpeg's progressive script, a restart every
    `restart_rows` MCU rows, (h, v) per component."""
    lib = _libjpeg_writer()
    if lib is None:
        raise RuntimeError("tests/torch_libjpeg_writer.cc needs g++ and libjpeg's headers")
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else 3
    hv = None if sampling is None else (ctypes.c_int * (2 * nc))(*[x for s in sampling for x in s])
    dac_arr = None if dac is None else (ctypes.c_int * 3)(*dac)
    out, size = ctypes.POINTER(ctypes.c_ubyte)(), ctypes.c_ulong()
    rc = lib.mp_write_jpeg(img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h, nc, quality, int(arith),
                           int(progressive), restart_rows, hv, dac_arr, ctypes.byref(out), ctypes.byref(size))
    if rc != 0:
        raise ValueError("libjpeg refused the parameters")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.mp_free(out)


# ---------------------------------------------------------------------------
# TIFF: a writer in either byte order, strips or tiles
# ---------------------------------------------------------------------------


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more repeat, the rest literal."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: a clear code first, the code width
    growing when the next free entry reaches 512, 1024 and 2048, a clear
    when it reaches 4094, and the end code."""
    out = _Bits(stuff=False)

    def width(n: int) -> int:
        return 12 if n >= 2048 else 11 if n >= 1024 else 10 if n >= 512 else 9

    table, nxt, nbits, w = {bytes([i]): i for i in range(256)}, 258, 9, b""
    out.put(256, 9)
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        out.put(table[w], nbits)
        table[wc] = nxt
        nxt += 1
        nbits = width(nxt)
        w = bytes([c])
        if nxt == 4094:
            out.put(256, nbits)
            table, nxt, nbits = {bytes([i]): i for i in range(256)}, 258, 9
    if w:
        out.put(table[w], nbits)
        nbits = width(nxt + 1)
    out.put(257, nbits)
    out.align(ones=False)
    return bytes(out.out)


def encode_tiff(img: np.ndarray, compression: int = 1, order: str = "<", predictor: int = 1,
                tile: tuple[int, int] | None = None, rows_per_strip: int | None = None,
                white_is_zero: bool = False) -> bytes:
    """`[H, W]` uint8 / uint16 or `[H, W, 3]` uint8 -> TIFF bytes: byte
    `order` "<" or ">", compression 1 (none), 5 (LZW), 8 (Deflate) or 32773
    (PackBits), `predictor` 2 for horizontal differencing, `tile` (w, h)
    multiples of 16 or strips of `rows_per_strip` rows, `white_is_zero`
    for 8-bit grey stored inverted (photometric 0)."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    depth = img.dtype.itemsize * 8
    dtype = np.dtype(order + ("u2" if depth == 16 else "u1"))
    stored = (255 - img) if white_is_zero else img
    stored = stored.astype(dtype).reshape(H, W, spp)
    if tile:
        bw, bh = tile
        pad = np.zeros((-(-H // bh) * bh, -(-W // bw) * bw, spp), dtype)
        pad[:H, :W] = stored
        parts = [pad[y : y + bh, x : x + bw] for y in range(0, pad.shape[0], bh) for x in range(0, pad.shape[1], bw)]
    else:
        rps = rows_per_strip or H
        parts = [stored[y : y + rps] for y in range(0, H, rps)]
    chunks = []
    for p in parts:
        if predictor == 2:
            p = p.copy()
            p[:, 1:] = (p[:, 1:].astype(np.int64) - p[:, :-1].astype(np.int64)) % (1 << depth)
        raw = np.ascontiguousarray(p, dtype).tobytes()
        chunks.append({1: lambda b: b, 5: lzw_encode, 8: zlib.compress, 32773: packbits_encode}[compression](raw))

    tags = {256: (4, [W]), 257: (4, [H]), 258: (3, [depth] * spp), 259: (3, [compression]),
            262: (3, [0 if white_is_zero else (2 if spp == 3 else 1)]), 277: (3, [spp]), 284: (3, [1])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]])})
    else:
        tags[278] = (4, [rows_per_strip or H])
    data = bytearray(order.replace("<", "II").replace(">", "MM").encode() + struct.pack(order + "HI", 42, 0))
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\0"
    tags[324 if tile else 273] = (4, offsets)
    tags[325 if tile else 279] = (4, [len(c) for c in chunks])
    extra = bytearray()
    ifd_at = len(data)
    entries_end = ifd_at + 2 + 12 * len(tags) + 4
    entries = bytearray(struct.pack(order + "H", len(tags)))
    for tag in sorted(tags):
        kind, values = tags[tag]
        code = "H" if kind == 3 else "I"
        payload = struct.pack(f"{order}{len(values)}{code}", *values)
        if len(payload) <= 4:
            entries += struct.pack(order + "HHI", tag, kind, len(values)) + payload.ljust(4, b"\0")
        else:
            entries += struct.pack(order + "HHII", tag, kind, len(values), entries_end + len(extra))
            extra += payload
    entries += struct.pack(order + "I", 0)
    data += entries + extra
    struct.pack_into(order + "I", data, 4, ifd_at)
    return bytes(data)


# ---------------------------------------------------------------------------
# PNG: a writer of every colour type, bit depth and interlace
# ---------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(raw: np.ndarray, unit: int, ftype: np.ndarray) -> np.ndarray:
    """PNG's row filters applied to `raw [H, rowbytes]` (each row its type
    of `ftype`): the filtered bytes, each row led by its type byte."""
    raw = raw.astype(np.int64)
    out = np.zeros((raw.shape[0], 1 + raw.shape[1]), np.uint8)
    for y, t in enumerate(ftype):
        row = raw[y]
        up = raw[y - 1] if y else np.zeros_like(row)
        a = np.concatenate([np.zeros(unit, np.int64), row[:-unit]])
        c = np.concatenate([np.zeros(unit, np.int64), up[:-unit]])
        pa, pb, pc = np.abs(up - c), np.abs(a - c), np.abs(a + up - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
        pred = [np.zeros_like(row), a, up, (a + up) >> 1, paeth][t]
        out[y, 0] = t
        out[y, 1:] = (row - pred) % 256
    return out


def encode_png_any(samples: np.ndarray, colour: int, depth: int, palette: np.ndarray | None = None,
                   trns: bytes | None = None, interlace: int = 0, seed: int = 0, ftype: int | None = None) -> bytes:
    """`samples` (`[H, W]` for grey and palette indices, `[H, W, C]`
    otherwise, each below 2^depth) -> PNG bytes of colour type `colour` at
    `depth` bits: sub-byte rows packed MSB first, `palette [N, 3]` as PLTE,
    `trns` as the tRNS chunk's body, Adam7 when `interlace`, every row with
    the filter type `ftype`, or one drawn from `seed`."""
    samples = np.asarray(samples).reshape(samples.shape[0], samples.shape[1], -1)
    H, W, C = samples.shape
    unit = max(1, C * depth // 8)
    rng = np.random.RandomState(seed)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = bytearray()
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        h, w = sub.shape[:2]
        if depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(h, -1)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(h, -1)
        else:
            per = 8 // depth
            flat = np.zeros((h, -(-w * C // per) * per), np.int64)
            flat[:, : w * C] = sub.reshape(h, -1)
            shifts = 8 - depth * (1 + np.arange(per))
            rows = (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
        data += _filter_rows(rows, unit, rng.randint(0, 5, h) if ftype is None else np.full(h, ftype)).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, interlace))
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    return out + png_chunk(b"IDAT", zlib.compress(bytes(data))) + png_chunk(b"IEND", b"")


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------


def _frames() -> list[np.ndarray]:
    from PIL import Image

    return [np.asarray(Image.open(p).convert("RGB"))
            for p in sorted(SYNTHDEMO.glob("test/*/rgb/*.png"))]


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_tiff(img: np.ndarray, mode: str | None = None, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(img)
    if mode is not None:
        im = Image.frombytes(mode, img.shape[::-1], img.astype(">u2").tobytes())
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _grey(img: np.ndarray) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).convert("L"))


def fixtures() -> dict[str, bytes]:
    """Relative path under `tests/data/torch_images` -> file bytes."""
    from PIL import Image

    frames = _frames()
    f0, f1, f2, f3 = frames[0], frames[5], frames[10], frames[21]
    odd = np.ascontiguousarray(f1[1:, 3:])  # 239x317
    big = np.concatenate([np.concatenate([f0, f1], 1), np.concatenate([f2, f3], 1)], 0)  # 480x640
    small = np.asarray(Image.fromarray(f2).resize((160, 120), Image.BICUBIC))
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: ignored by both decoders
    exif[0x010F] = "megapose"
    out = {
        "jpeg/444_q90.jpg": _pil_jpeg(f0, quality=90, subsampling=0),
        "jpeg/422_q75.jpg": _pil_jpeg(f3, quality=75, subsampling=1),
        "jpeg/420_q50_239x317.jpg": _pil_jpeg(odd, quality=50, subsampling=2),
        "jpeg/440_q85_239x317.jpg": encode_jpeg(odd, 85, [(1, 2), (1, 1), (1, 1)]),
        "jpeg/411_q80_restart.jpg": encode_jpeg(f2, 80, [(4, 1), (1, 1), (1, 1)], restart=7),
        "jpeg/mixed_extended_q16.jpg": encode_jpeg(small, 12, [(2, 2), (2, 1), (1, 2)], sof=0xC1, q16=True),
        "jpeg/grey_q70.jpg": _pil_jpeg(_grey(f1), quality=70),
        "jpeg/progressive_420_239x317.jpg": _pil_jpeg(odd, quality=90, progressive=True),
        "jpeg/progressive_grey.jpg": _pil_jpeg(_grey(f3), quality=80, progressive=True),
        "jpeg/restart_optimized_420.jpg": _pil_jpeg(f3, quality=88, restart_marker_blocks=5, optimize=True),
        "jpeg/444_q100.jpg": _pil_jpeg(small, quality=100, subsampling=0),
        "jpeg/exif_420.jpg": _pil_jpeg(f0, quality=92, exif=exif.tobytes()),
        "jpeg/adobe_rgb.jpg": _pil_jpeg(small, quality=90, keep_rgb=True, subsampling=0),
        "jpeg/420_q95_480x640.jpg": _pil_jpeg(big, quality=95, subsampling=2),
        "jpeg/arith_420_restart_239x317.jpg": libjpeg_jpeg(odd, 85, sampling=[(2, 2), (1, 1), (1, 1)],
                                                           restart_rows=3),
        "jpeg/arith_progressive_444.jpg": libjpeg_jpeg(small, 90, progressive=True, sampling=[(1, 1)] * 3,
                                                       dac=(1, 3, 7)),
        "tiff/grey8.tif": _pil_tiff(_grey(small)),
        "tiff/grey8_lzw_predictor.tif": _pil_tiff(_grey(f1), compression="tiff_lzw", tiffinfo={317: 2}),
        "tiff/grey8_packbits_be.tif": encode_tiff(_grey(small), 32773, ">", rows_per_strip=16),
        "tiff/grey16_deflate.tif": _pil_tiff(_grey(small).astype(np.uint16) * 257, compression="tiff_adobe_deflate"),
        "tiff/grey16_lzw_predictor_be.tif": encode_tiff(_grey(odd).astype(np.uint16) * 199, 5, ">", 2,
                                                        rows_per_strip=40),
        "tiff/rgb8_deflate_predictor.tif": _pil_tiff(small, compression="tiff_adobe_deflate", tiffinfo={317: 2}),
        "tiff/grey8_tiled_deflate_be.tif": encode_tiff(_grey(odd), 8, ">", tile=(64, 48)),
        "tiff/grey8_white_is_zero_lzw.tif": encode_tiff(_grey(small), 5, "<", white_is_zero=True, rows_per_strip=24),
    }
    names = sorted(SYNTHDEMO.glob("test/*/rgb/*.png"))
    for path, img in zip(names, frames):
        scene = path.parent.parent.name
        out[f"bop/synthdemo_jpg/test/{scene}/rgb/{path.stem}.jpg"] = _pil_jpeg(img, quality=95, subsampling=2)
        if scene == ITODD_SCENE:
            out[f"bop/itodd_gray/test/{scene}/gray/{path.stem}.tif"] = _pil_tiff(
                _grey(img), compression="tiff_adobe_deflate")
    return {**out, **png_cases(), **texture_copies()}


def _texture(i: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(TEXTURES / f"obj_00000{i}.png").convert("RGB"))


def _quantized(img: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's median cut of `img` to at most `n` colours, undithered: the
    indices `[H, W]` and the palette `[K, 3]` they use."""
    from PIL import Image

    q = Image.fromarray(img).quantize(n, dither=Image.Dither.NONE)
    idx = np.asarray(q)
    return idx, np.asarray(q.getpalette(), np.uint8).reshape(-1, 3)[: int(idx.max()) + 1]


def _commonest(values: np.ndarray) -> np.ndarray:
    """The most frequent value (row of the last axis) of `values`."""
    flat = values.reshape(-1, values.shape[-1]) if values.ndim > 2 else values.reshape(-1, 1)
    uniq, counts = np.unique(flat, axis=0, return_counts=True)
    return uniq[counts.argmax()]


def png_cases() -> dict[str, bytes]:
    """`png/<case>.png`: one small image (24x32 to 64x64, cut from the
    committed textures) per layout that libpng reads and `decode.cc`
    expands: palette at 8, 4 and (Adam7, with tRNS) 2 bits, tRNS on
    palette, RGB and grey, grey at 1, 2 and 4 bits with and without tRNS,
    grey with alpha, Adam7 RGB and Adam7 1-bit grey."""
    t1, t2 = _texture(1), _texture(2)
    rgb = np.ascontiguousarray(t1[20:68, 40:104])  # 48x64
    luma = _grey(np.ascontiguousarray(t2[100:164, 30:94]))  # 64x64
    idx8, pal8 = _quantized(rgb, 256)
    idx4, pal4 = _quantized(np.ascontiguousarray(t2[0:32, 0:40]), 16)
    idx_t, pal_t = _quantized(np.ascontiguousarray(t1[100:140, 100:148]), 256)
    idx2, pal2 = _quantized(np.ascontiguousarray(t2[50:79, 60:103]), 4)
    small = np.ascontiguousarray(t2[60:84, 10:42])  # 24x32
    g4 = luma[:40, :56] >> 4
    g8 = luma[8:56, 4:60]
    odd = np.ascontiguousarray(t1[3:48, 70:131])  # 45x61, every Adam7 pass partial
    return {
        "png/palette8_48x64.png": encode_png_any(idx8, 3, 8, palette=pal8, seed=1),
        "png/palette4_32x40.png": encode_png_any(idx4, 3, 4, palette=pal4, seed=2),
        "png/palette8_trns_40x48.png": encode_png_any(
            idx_t, 3, 8, palette=pal_t, trns=bytes(np.arange(len(pal_t) // 2, dtype=np.uint8) * 9), seed=3),
        "png/adam7_palette2_trns_29x43.png": encode_png_any(idx2, 3, 2, palette=pal2, trns=bytes([0, 128]),
                                                            interlace=1, seed=4),
        "png/rgb_trns_24x32.png": encode_png_any(small, 2, 8, trns=struct.pack(">3H", *_commonest(small)), seed=5),
        "png/grey1_64x64.png": encode_png_any(luma > 128, 0, 1, seed=6),
        "png/grey1_trns_64x64.png": encode_png_any(luma > 100, 0, 1, trns=struct.pack(">H", 0), seed=7),
        "png/grey2_64x64.png": encode_png_any(luma >> 6, 0, 2, seed=8),
        "png/grey4_40x56.png": encode_png_any(g4, 0, 4, seed=9),
        "png/grey4_trns_40x56.png": encode_png_any(g4, 0, 4, trns=struct.pack(">H", *_commonest(g4)), seed=10),
        "png/grey8_trns_48x56.png": encode_png_any(g8, 0, 8, trns=struct.pack(">H", *_commonest(g8)), seed=11),
        "png/grey_alpha_48x64.png": encode_png_any(np.stack([_grey(rgb), rgb[..., 0]], -1), 4, 8, seed=12),
        "png/adam7_rgb_45x61.png": encode_png_any(odd, 2, 8, interlace=1, seed=13),
        "png/adam7_grey1_37x53.png": encode_png_any(luma[:37, :53] > 90, 0, 1, interlace=1, seed=14),
    }


def texture_copies() -> dict[str, bytes]:
    """`textures/obj_00000{1,2}_<format>`: each committed texture as an
    Adam7 RGB PNG, an RGB PNG with tRNS (its commonest colour), an RGBA PNG
    (alpha its luma), a 256-colour palette PNG (lossy) and a JPEG (quality
    95, 4:2:0, lossy), each PNG with one row filter throughout (smaller
    files). The first three hold the texture's own pixels."""
    out = {}
    for i in (1, 2):
        tex = _texture(i)
        idx, pal = _quantized(tex, 256)
        for fmt, data in zip(TEXTURE_FORMATS, (
                encode_png_any(tex, 2, 8, interlace=1, ftype=0),
                encode_png_any(tex, 2, 8, trns=struct.pack(">3H", *_commonest(tex)), ftype=2),
                encode_png_any(np.concatenate([tex, _grey(tex)[..., None]], -1), 6, 8, ftype=2),
                encode_png_any(idx, 3, 8, palette=pal, ftype=0),
                _pil_jpeg(tex, quality=95, subsampling=2))):
            out[f"textures/obj_00000{i}_{fmt}"] = data
    return out


def reference_decode(rel: str, data: bytes) -> np.ndarray:
    """The array `hashes.json` holds for fixture `rel`: libpng's through the
    JAX package's native decoder for a PNG, else PIL's."""
    if rel.endswith(".png"):
        from megapose6d_tpu import native as jnative

        return jnative.decode_image(data)
    return pil_decode(data)


def pil_decode(data: bytes) -> np.ndarray:
    """PIL's decode, handing libjpeg the whole file at once (its arithmetic
    decoder cannot wait for more data, which PIL's 64 KiB reads would ask
    of it)."""
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    im.decodermaxblock = max(im.decodermaxblock, len(data))
    return np.asarray(im)


def main() -> int:
    files = fixtures()
    for rel, data in files.items():
        path = OUT / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    hashes = {rel: array_hash(reference_decode(rel, data)) for rel, data in sorted(files.items())}
    (OUT / "hashes.json").write_text(json.dumps(hashes, indent=1) + "\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} files, {total} bytes, in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
