"""Host C++ for the input pipeline, bound with ctypes.

Counterpart of `megapose6d_tpu/native/__init__.py`, with the package's own
copies of its sources:
  - `decode.cc`: PNG and JPEG decoding through libpng and libjpeg, a batch
    in a thread pool;
  - `meshproc.cc`: vertex-clustering decimation, the whole binary search
    on the cell size in one call;
and three of its own, which need only a compiler:
  - `unfilter.cc`: PNG row unfiltering, for `utils/png.py`;
  - `jpeg.cc`: a JPEG decoder equal bit for bit to libjpeg-turbo's default
    output (baseline, extended and progressive, Huffman or arithmetic
    coded, 8-bit, grey or 3 components), a batch in threads;
  - `tiff.cc`: TIFF's LZW and PackBits strips, for `utils/tiff.py`;
  - `zstd.cc`: a Zstandard decoder and encoder (RFC 8878) and CRC32C, for
    the orbax checkpoints' OCDBT stores (`utils/ocdbt.py`,
    `interop/orbax.py`); it has no fallback, so without a compiler a read
    or a write raises with the compiler's message.
Each is compiled with `g++` at first use into `build/` at the repository
root (named by the hash of its source and flags; the JAX package's
libraries are never loaded), then bound with ctypes. Without libpng and
libjpeg `available()` is False: PNGs are then decoded by `utils/png.py`
(`decode_image` routes them there, with the same arrays, unfiltered by
`unfilter.cc` when it builds, else by numpy) and JPEGs by `jpeg.cc` (without
a compiler a JPEG raises with the compiler's message). TIFFs always go
through `utils/tiff.py`. Without `meshproc`,
`meshes/io.simplify_vertex_clustering` runs its numpy twin.

    available() -> bool
    supports(data: bytes) -> bool              # PNG or JPEG: what decode.cc reads
    decoder() -> "native", "png.py + unfilter.cc, jpeg.cc", ... or "png.py"
    decode_image(data: bytes) -> np.ndarray   # [H, W, C] u8, [H, W] u8 or u16
    decode_batch(list[bytes], n_threads=0) -> list[np.ndarray]
    decode_jpeg(data: bytes) -> np.ndarray     # always jpeg.cc
    decode_zstd(data: bytes, max_size: int) -> bytes
    decode_zstd_into(data: bytes, out: np.ndarray) -> int   # bytes written
    encode_zstd(data) -> bytes                 # one frame
    crc32c(data: bytes) -> int
    meshproc_available() -> bool
    simplify_mesh(verts, faces, colors, target_faces) -> (verts, faces, colors | None)
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._nvcc import BUILD_DIR
from ..utils import tiff as tiff_py
from ..utils.png import decode_png
from ..utils.png import unfilter as png_unfilter

logger = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LIBS = {"decode": ("-lpng", "-ljpeg", "-lz", "-lpthread"), "meshproc": (), "unfilter": (), "jpeg": ("-lpthread",),
         "tiff": (), "zstd": ()}
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}

u8p = ctypes.POINTER(ctypes.c_ubyte)
i32p = ctypes.POINTER(ctypes.c_int)
f32p = ctypes.POINTER(ctypes.c_float)
_MSG = 256  # bytes of a jpeg.cc error message


def _build(name: str) -> Path | None:
    """`build/<name>-<hash>.so` from `<name>.cc`, compiled if missing (to a
    per-process file, then renamed, so concurrent workers do not race). A
    failed build leaves `<name>-<hash>.failed` with the compiler's message,
    so the loader's workers do not each try again."""
    src = _DIR / f"{name}.cc"
    flags = (*_FLAGS, *_LIBS[name])
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    failed = out.with_suffix(".failed")
    if out.exists():
        return out
    if failed.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *_FLAGS, str(src), "-o", str(tmp), *_LIBS[name]]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=180)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as e:
        message = (getattr(e, "stderr", "") or str(e))[:500]
        logger.info("native %s unavailable (build failed): %s", name, message)
        failed.write_text(message)
        tmp.unlink(missing_ok=True)
        return None
    return out


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "jpeg":
        lib.mp_jpeg_info.argtypes = [u8p, ctypes.c_long, i32p, i32p, i32p, ctypes.c_char_p, ctypes.c_int]
        lib.mp_jpeg_info.restype = ctypes.c_int
        lib.mp_jpeg_decode.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, i32p, i32p, i32p, ctypes.c_char_p,
                                       ctypes.c_int]
        lib.mp_jpeg_decode.restype = ctypes.c_int
        lib.mp_jpeg_decode_batch.argtypes = [
            ctypes.c_int, ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_long), ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_long), i32p, i32p, i32p, i32p, ctypes.c_int,
        ]
        lib.mp_jpeg_decode_batch.restype = ctypes.c_int
    elif name == "tiff":
        lib.mp_tiff_lzw.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long]
        lib.mp_tiff_lzw.restype = ctypes.c_long
        lib.mp_tiff_packbits.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long]
        lib.mp_tiff_packbits.restype = ctypes.c_long
    elif name == "zstd":
        lib.mp_zstd_content_size.argtypes = [u8p, ctypes.c_long, ctypes.c_char_p, ctypes.c_int]
        lib.mp_zstd_content_size.restype = ctypes.c_long
        lib.mp_zstd_decode.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
                                       ctypes.c_char_p, ctypes.c_int]
        lib.mp_zstd_decode.restype = ctypes.c_int
        lib.mp_zstd_encode_bound.argtypes = [ctypes.c_long]
        lib.mp_zstd_encode_bound.restype = ctypes.c_long
        lib.mp_zstd_encode.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, ctypes.c_char_p, ctypes.c_int]
        lib.mp_zstd_encode.restype = ctypes.c_long
        lib.mp_crc32c.argtypes = [u8p, ctypes.c_long]
        lib.mp_crc32c.restype = ctypes.c_uint
    elif name == "unfilter":
        lib.mp_png_unfilter.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        lib.mp_png_unfilter.restype = ctypes.c_int
    elif name == "decode":
        lib.mp_image_info.argtypes = [u8p, ctypes.c_long, i32p, i32p, i32p, i32p]
        lib.mp_image_info.restype = ctypes.c_int
        lib.mp_decode_image.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, i32p, i32p, i32p, i32p]
        lib.mp_decode_image.restype = ctypes.c_int
        lib.mp_decode_batch.argtypes = [
            ctypes.c_int, ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_long), ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_long), i32p, i32p, i32p, i32p, ctypes.c_int,
        ]
        lib.mp_decode_batch.restype = ctypes.c_int
    else:
        lib.mp_simplify_mesh.argtypes = [
            f32p, ctypes.c_int, i32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int, f32p, i32p, f32p, i32p, i32p,
        ]
        lib.mp_simplify_mesh.restype = ctypes.c_int


def _load(name: str) -> ctypes.CDLL | None:
    with _lock:
        if name not in _libs:
            lib, path = None, _build(name)
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                    _bind(name, lib)
                except OSError as e:
                    logger.info("native %s unavailable (load failed): %s", name, e)
                    lib = None
            _libs[name] = lib
            if name == "decode" and lib is None:
                logger.info("no native image decoder: PNG through utils/png.py, JPEG through jpeg.cc")
        return _libs[name]


def available() -> bool:
    """True when the native decoder is built and loaded."""
    return _load("decode") is not None


def supports(data: bytes) -> bool:
    """True for the formats `decode.cc` reads, PNG and JPEG, by their magic
    bytes. `decode_image` also reads TIFF (through `utils/tiff.py`), which
    this says False to, as the JAX package's `supports` does."""
    head = bytes(data[:4])
    return head.startswith(b"\x89PNG") or head.startswith(b"\xff\xd8\xff")


def decoder() -> str:
    """Which decoders `decode_image` uses for PNG and JPEG: "native"
    (libpng, libjpeg), else "png.py + unfilter.cc, jpeg.cc", "png.py,
    jpeg.cc" or "png.py" (no JPEG). Loads every decoder library, so that a
    parent process builds them once for its workers."""
    _load("tiff")
    if available():
        return "native"
    route = "png.py + unfilter.cc" if _load("unfilter") is not None else "png.py"
    return route + (", jpeg.cc" if _load("jpeg") is not None else "")


def unfilter(filtered: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """`utils/png.unfilter` (`filtered [H, W, bpp]` uint8, `ftype [H]`)
    through `unfilter.cc` when it builds, else in numpy."""
    lib = _load("unfilter")
    if lib is None:
        return png_unfilter(filtered, ftype)
    f = np.ascontiguousarray(filtered, np.uint8)
    t = np.ascontiguousarray(ftype, np.uint8)
    out = np.empty_like(f)
    if lib.mp_png_unfilter(f.ctypes.data_as(u8p), t.ctypes.data_as(u8p), f.shape[0], f.shape[1], f.shape[2],
                           out.ctypes.data_as(u8p)) != 0:
        raise ValueError(f"bad PNG row filter {int(t.max())}")
    return out


def meshproc_available() -> bool:
    return _load("meshproc") is not None


def _wrap(out: np.ndarray, h: int, w: int, c: int, bd: int) -> np.ndarray:
    if bd == 16:
        return out[: h * w * 2].view(np.uint16).reshape(h, w)
    if c == 1:
        return out[: h * w].reshape(h, w)
    return out[: h * w * c].reshape(h, w, c)


def _info(lib: ctypes.CDLL, src, n: int) -> tuple[int, int, int, int, int]:
    h, w, c, bd = (ctypes.c_int() for _ in range(4))
    rc = lib.mp_image_info(src, n, h, w, c, bd)
    if rc != 0:
        raise ValueError(f"mp_image_info failed: {rc}")
    cap = h.value * w.value * max(c.value, 1) * (2 if bd.value == 16 else 1)
    return h.value, w.value, c.value, bd.value, cap


def _is_tiff(data) -> bool:
    return bytes(data[:4]) in (b"II*\0", b"MM\0*")


def _is_jpeg(data) -> bool:
    return bytes(data[:2]) == b"\xff\xd8"


def decode_image(data: bytes) -> np.ndarray:
    """Decode one PNG, JPEG or TIFF: uint8 `[H, W, C]` / `[H, W]`, or uint16
    `[H, W]` for 16-bit grey. Without the native library PNGs go through
    `utils/png.py` and JPEGs through `jpeg.cc`; TIFFs always go through
    `utils/tiff.py`."""
    if _is_tiff(data):
        return decode_tiff(data)
    lib = _load("decode")
    if lib is None:
        if _is_jpeg(data):
            return decode_jpeg(data)
        return decode_png(data, unfilter)
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(u8p)
    h, w, c, bd, cap = _info(lib, src, len(data))
    out = np.empty(cap, np.uint8)
    hh, ww, cc, bb = (ctypes.c_int() for _ in range(4))
    rc = lib.mp_decode_image(src, len(data), out.ctypes.data_as(u8p), cap, hh, ww, cc, bb)
    if rc != 0:
        raise ValueError(f"mp_decode_image failed: {rc}")
    return _wrap(out, hh.value, ww.value, cc.value, bb.value)


def decode_batch(datas: list[bytes], n_threads: int = 0) -> list[np.ndarray]:
    """Decode a batch in C++ threads (`n_threads=0`: one per core): through
    libpng and libjpeg where `decode.cc` builds, else the JPEGs through
    `jpeg.cc` and the rest one by one."""
    n_threads = n_threads if n_threads > 0 else os.cpu_count() or 1
    lib = _load("decode")
    if lib is None or any(_is_tiff(d) for d in datas):
        jpegs = [i for i, d in enumerate(datas) if _is_jpeg(d)] if lib is None else []
        out = dict(zip(jpegs, _jpeg_batch([datas[i] for i in jpegs], n_threads)))
        return [out[i] if i in out else decode_image(d) for i, d in enumerate(datas)]
    n = len(datas)
    if n == 0:
        return []
    srcs = [np.frombuffer(d, np.uint8) for d in datas]
    outs_np, caps = [], (ctypes.c_long * n)()
    outs = (u8p * n)()
    for i, s in enumerate(srcs):
        cap = _info(lib, s.ctypes.data_as(u8p), len(s))[4]
        outs_np.append(np.empty(cap, np.uint8))
        caps[i], outs[i] = cap, outs_np[-1].ctypes.data_as(u8p)
    hs, ws, cs, bds = ((ctypes.c_int * n)() for _ in range(4))
    rc = lib.mp_decode_batch(n, (u8p * n)(*[s.ctypes.data_as(u8p) for s in srcs]),
                             (ctypes.c_long * n)(*[len(s) for s in srcs]), outs, caps, hs, ws, cs, bds, n_threads)
    if rc != 0:
        raise ValueError(f"mp_decode_batch failed: {rc}")
    return [_wrap(outs_np[i], hs[i], ws[i], cs[i], bds[i]) for i in range(n)]


def _required(name: str, what: str) -> ctypes.CDLL:
    """The library `name`, or RuntimeError with the compiler's message."""
    lib = _load(name)
    if lib is None:
        failed = next(BUILD_DIR.glob(f"{name}-*.failed"), None)
        message = failed.read_text() if failed is not None else "no compiler"
        raise RuntimeError(f"{what} need {name}.cc, which did not build: {message}")
    return lib


def _jpeg_lib() -> ctypes.CDLL:
    return _required("jpeg", "JPEG images")


def _jpeg_shape(lib: ctypes.CDLL, buf: np.ndarray) -> tuple[int, int, int]:
    h, w, c = (ctypes.c_int() for _ in range(3))
    msg = ctypes.create_string_buffer(_MSG)
    if lib.mp_jpeg_info(buf.ctypes.data_as(u8p), len(buf), h, w, c, msg, _MSG) != 0:
        raise ValueError(f"JPEG: {msg.value.decode()}")
    return h.value, w.value, c.value


def _jpeg_array(out: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, 3)


def decode_jpeg(data: bytes) -> np.ndarray:
    """One JPEG through `jpeg.cc` (whether or not libjpeg is present):
    `[H, W]` uint8 for grey, `[H, W, 3]` uint8 RGB. Raises ValueError, with
    libjpeg's reason where it has one, on what it does not decode."""
    lib = _jpeg_lib()
    buf = np.frombuffer(data, np.uint8)
    h, w, c = _jpeg_shape(lib, buf)
    out = np.empty(h * w * c, np.uint8)
    hh, ww, cc = (ctypes.c_int() for _ in range(3))
    msg = ctypes.create_string_buffer(_MSG)
    if lib.mp_jpeg_decode(buf.ctypes.data_as(u8p), len(buf), out.ctypes.data_as(u8p), out.size, hh, ww, cc,
                          msg, _MSG) != 0:
        raise ValueError(f"JPEG: {msg.value.decode()}")
    return _jpeg_array(out, h, w, c)


def _jpeg_batch(datas: list[bytes], n_threads: int) -> list[np.ndarray]:
    """JPEGs through `jpeg.cc` in `n_threads` C++ threads; a file that
    fails is decoded again alone for its message."""
    if not datas:
        return []
    lib, n = _jpeg_lib(), len(datas)
    bufs = [np.frombuffer(d, np.uint8) for d in datas]
    shapes = [_jpeg_shape(lib, b) for b in bufs]
    outs = [np.empty(h * w * c, np.uint8) for h, w, c in shapes]
    hs, ws, cs, rcs = ((ctypes.c_int * n)() for _ in range(4))
    failed = lib.mp_jpeg_decode_batch(n, (u8p * n)(*[b.ctypes.data_as(u8p) for b in bufs]),
                                      (ctypes.c_long * n)(*[len(b) for b in bufs]),
                                      (u8p * n)(*[o.ctypes.data_as(u8p) for o in outs]),
                                      (ctypes.c_long * n)(*[o.size for o in outs]), hs, ws, cs, rcs, n_threads)
    if failed:
        decode_jpeg(datas[next(i for i in range(n) if rcs[i] != 0)])  # raises with the message
    return [_jpeg_array(o, *s) for o, s in zip(outs, shapes)]


def _strips(name: str, data: bytes, size: int) -> bytes:
    """One LZW or PackBits strip through `tiff.cc`, decoded to `size` bytes
    (fewer where the strip ends early; `utils/tiff.py` checks)."""
    lib = _load("tiff")
    if lib is None:
        return (tiff_py.lzw_decode if name == "lzw" else tiff_py.packbits_decode)(data, size)
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(size, 1), np.uint8)
    fn = lib.mp_tiff_lzw if name == "lzw" else lib.mp_tiff_packbits
    n = fn(src.ctypes.data_as(u8p), len(src), out.ctypes.data_as(u8p), size)
    if n < 0:
        raise ValueError(f"TIFF: corrupt {'LZW' if name == 'lzw' else 'PackBits'} data")
    return out[:n].tobytes()


def decode_tiff(data: bytes) -> np.ndarray:
    """`utils/tiff.decode_tiff`, its LZW and PackBits strips through
    `tiff.cc` when it builds (else its Python twins, the same bytes)."""
    return tiff_py.decode_tiff(data, lzw=lambda d, n: _strips("lzw", d, n),
                               packbits=lambda d, n: _strips("packbits", d, n))


def _zstd_run(lib: ctypes.CDLL, src: np.ndarray, out: np.ndarray) -> int | None:
    """Decode `src` into `out`: the bytes written, or None when `out` is too small."""
    n = ctypes.c_long()
    msg = ctypes.create_string_buffer(_MSG)
    rc = lib.mp_zstd_decode(src.ctypes.data_as(u8p), src.size, out.ctypes.data_as(u8p), out.size, ctypes.byref(n),
                            msg, _MSG)
    if rc == 1:
        raise ValueError(f"zstd: {msg.value.decode()}")
    return None if rc == 2 else n.value


def decode_zstd(data: bytes, max_size: int) -> bytes:
    """Every zstd frame of `data` (skippable frames skipped), decoded by
    `zstd.cc`. Raises ValueError on corrupt or truncated input, a frame
    that needs a dictionary, a failed content checksum, or output over
    `max_size` bytes. Frames without a declared content size decode into a
    buffer that doubles until it fits."""
    lib = _required("zstd", "zstd data")
    src = np.frombuffer(data, np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    size = lib.mp_zstd_content_size(src.ctypes.data_as(u8p), src.size, msg, _MSG)
    if size == -2:
        raise ValueError(f"zstd: {msg.value.decode()}")
    if size > max_size:
        raise ValueError(f"zstd: {size} bytes declared, more than the {max_size} allowed")
    cap = size if size >= 0 else min(max_size, max(4 * src.size, 1 << 16))
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = _zstd_run(lib, src, out[:cap])
        if n is not None:
            return out[:n].tobytes()
        if cap >= max_size:
            raise ValueError(f"zstd: more than the {max_size} bytes allowed")
        cap = min(max_size, 2 * cap)


def decode_zstd_into(data: bytes, out: np.ndarray) -> int:
    """Decode `data` into the C-contiguous array `out` (any dtype; its
    bytes are written in place); returns the bytes written. Raises
    ValueError as `decode_zstd` does, and when the output does not fit."""
    lib = _required("zstd", "zstd data")
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("decode_zstd_into needs a writeable C-contiguous array")
    n = _zstd_run(lib, np.frombuffer(data, np.uint8), out.reshape(-1).view(np.uint8))
    if n is None:
        raise ValueError(f"zstd: the data decodes to more than {out.nbytes} bytes")
    return n


def encode_zstd(data) -> bytes:
    """`data` (bytes, or any C-contiguous buffer such as a numpy array) as
    one zstd frame by `zstd.cc`'s encoder: the content size declared,
    blocks of at most 128 KiB, each raw, RLE or compressed, whichever is
    smallest. libzstd and `decode_zstd` decode it."""
    lib = _required("zstd", "zstd data")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(lib.mp_zstd_encode_bound(src.size), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    n = lib.mp_zstd_encode(src.ctypes.data_as(u8p), src.size, out.ctypes.data_as(u8p), out.size, msg, _MSG)
    if n < 0:
        raise ValueError(f"zstd: {msg.value.decode()}")
    return out[:n].tobytes()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`, through `zstd.cc`."""
    lib = _required("zstd", "CRC32C")
    src = np.frombuffer(data, np.uint8)
    return int(lib.mp_crc32c(src.ctypes.data_as(u8p), src.size))


def simplify_mesh(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray | None, target_faces: int,
                  max_iters: int = 32) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Decimate to at most `target_faces` faces (C++ vertex clustering):
    `verts [V, 3]` f32, `faces [F, 3]` i32, `colors [V, 3]` f32 or None."""
    lib = _load("meshproc")
    if lib is None:
        raise RuntimeError("native meshproc not available")
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    c = None if colors is None else np.ascontiguousarray(colors, np.float32)
    out_v, out_f = np.empty_like(v), np.empty_like(f)
    out_c = None if c is None else np.empty_like(c)
    nv, nf = ctypes.c_int(), ctypes.c_int()
    rc = lib.mp_simplify_mesh(
        v.ctypes.data_as(f32p), len(v), f.ctypes.data_as(i32p), len(f),
        None if c is None else c.ctypes.data_as(f32p), int(target_faces), int(max_iters),
        out_v.ctypes.data_as(f32p), out_f.ctypes.data_as(i32p),
        None if out_c is None else out_c.ctypes.data_as(f32p), ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        raise ValueError(f"mp_simplify_mesh failed: {rc}")
    return (out_v[: nv.value].copy(), out_f[: nf.value].copy(),
            None if out_c is None else out_c[: nv.value].copy())
