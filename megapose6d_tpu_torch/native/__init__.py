"""Host C++ for the input pipeline, bound with ctypes.

Counterpart of `megapose6d_tpu/native/__init__.py`, with the package's own
copies of its sources:
  - `decode.cc`: PNG and JPEG decoding through libpng and libjpeg, a batch
    in a thread pool;
  - `meshproc.cc`: vertex-clustering decimation, the whole binary search
    on the cell size in one call;
and one of its own, `unfilter.cc`: PNG row unfiltering, for `utils/png.py`
where libpng is missing (it needs only a compiler).
Each is compiled with `g++` at first use into `build/` at the repository
root (named by the hash of its source and flags; the JAX package's
libraries are never loaded), then bound with ctypes. Without a compiler,
or without libpng and libjpeg, `available()` / `meshproc_available()` are
False: PNGs are then decoded by `utils/png.py` (`decode_image` routes
them there, with the same arrays, unfiltered by `unfilter.cc` when it
builds, else by numpy), a JPEG raises, and
`meshes/io.simplify_vertex_clustering` runs its numpy twin.

    available() -> bool
    decoder() -> "native", "png.py + unfilter.cc" or "png.py"
    decode_image(data: bytes) -> np.ndarray   # [H, W, C] u8, [H, W] u8 or u16
    decode_batch(list[bytes], n_threads=0) -> list[np.ndarray]
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
from ..utils.png import decode_png
from ..utils.png import unfilter as png_unfilter

logger = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LIBS = {"decode": ("-lpng", "-ljpeg", "-lz", "-lpthread"), "meshproc": (), "unfilter": ()}
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}

u8p = ctypes.POINTER(ctypes.c_ubyte)
i32p = ctypes.POINTER(ctypes.c_int)
f32p = ctypes.POINTER(ctypes.c_float)


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
    if name == "unfilter":
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
                logger.info("no native image decoder: PNG through utils/png.py, JPEG refused")
        return _libs[name]


def available() -> bool:
    """True when the native decoder is built and loaded."""
    return _load("decode") is not None


def decoder() -> str:
    """Which decoder `decode_image` uses: "native" (libpng, libjpeg), else
    "png.py + unfilter.cc" or "png.py" (no JPEG either way)."""
    if available():
        return "native"
    return "png.py + unfilter.cc" if _load("unfilter") is not None else "png.py"


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


def decode_image(data: bytes) -> np.ndarray:
    """Decode one PNG or JPEG: uint8 `[H, W, C]` / `[H, W]`, or uint16
    `[H, W]` for 16-bit PNG. Without the native library PNGs go through
    `utils/png.py` and a JPEG raises."""
    lib = _load("decode")
    if lib is None:
        if bytes(data[:4]).startswith(b"\x89PNG"):
            return decode_png(data, unfilter)
        raise RuntimeError("JPEG images need the native decoder (g++ with libjpeg), which did not build")
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
    """Decode a batch in C++ threads (`n_threads=0`: one per core)."""
    lib = _load("decode")
    if lib is None:
        return [decode_image(d) for d in datas]
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
                             (ctypes.c_long * n)(*[len(s) for s in srcs]), outs, caps, hs, ws, cs, bds,
                             n_threads if n_threads > 0 else os.cpu_count() or 1)
    if rc != 0:
        raise ValueError(f"mp_decode_batch failed: {rc}")
    return [_wrap(outs_np[i], hs[i], ws[i], cs[i], bds[i]) for i in range(n)]


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
