"""Port vs PIL: the port's PNG decoder on every committed PNG of the BOP
test sets (textures, RGB frames, 16-bit depth, masks), bit for bit, and
its refusals."""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from megapose6d_tpu_torch.utils.png import decode_png, read_png, unfilter

RUNS = Path(__file__).resolve().parents[1] / "runs"
KINDS = ("models", "rgb", "depth", "mask_visib")


def committed_pngs(kind):
    return sorted(p for ds in ("ar_dr", "ar_baseline")
                  for p in (RUNS / ds / "synthdemo").rglob(f"{kind}/*.png"))


@pytest.mark.parametrize("kind", KINDS)
def test_committed_pngs_match_pil(kind):
    files = committed_pngs(kind)
    assert files
    for path in files:
        expected = np.asarray(Image.open(path))
        got = read_png(path)
        assert got.dtype == expected.dtype and got.shape == expected.shape, path
        np.testing.assert_array_equal(got, expected, err_msg=str(path))


def png_bytes(rows: np.ndarray, ftype: np.ndarray, colour: int, depth: int, interlace: int = 0) -> bytes:
    """A PNG of already-filtered rows `[H, 1 + W*bpp]`."""
    H, n = rows.shape
    bpp = {0: 1, 2: 3, 6: 4}[colour] * depth // 8
    W = (n - 1) // bpp

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    rows = rows.copy()
    rows[:, 0] = ftype
    ihdr = struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour,depth", [(0, 8), (0, 16), (2, 8), (6, 8)])
def test_every_filter_matches_pil(tmp_path, colour, depth):
    """Random filtered bytes with every filter type on every row, mixed:
    whatever they decode to, PIL must agree."""
    rng = np.random.RandomState(colour * 100 + depth)
    bpp = {0: 1, 2: 3, 6: 4}[colour] * depth // 8
    H, W = 23, 17
    rows = rng.randint(0, 256, size=(H, 1 + W * bpp))
    ftype = rng.randint(0, 5, size=H)
    data = png_bytes(rows, ftype, colour, depth)
    (tmp_path / "x.png").write_bytes(data)
    expected = np.asarray(Image.open(tmp_path / "x.png"))
    got = decode_png(data)
    assert got.dtype == expected.dtype and got.shape == expected.shape
    np.testing.assert_array_equal(got, expected)


def test_unfilter_matches_a_byte_loop():
    """The diagonal wavefront against the PNG specification's per-byte
    loop."""
    rng = np.random.RandomState(1)
    H, W, bpp = 9, 11, 3
    f = rng.randint(0, 256, size=(H, W, bpp)).astype(np.uint8)
    ftype = np.array([4, 3, 1, 2, 0, 4, 4, 3, 1])
    out = np.zeros((H, W * bpp), np.int64)
    flat = f.reshape(H, W * bpp).astype(np.int64)
    for y in range(H):
        for i in range(W * bpp):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y else 0
            c = out[y - 1, i - bpp] if y and i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = [0, a, b, (a + b) // 2, paeth][ftype[y]]
            out[y, i] = (flat[y, i] + pred) % 256
    np.testing.assert_array_equal(unfilter(f, ftype), out.reshape(H, W, bpp))


@pytest.mark.parametrize("colour,depth,interlace", [(2, 16, 0), (3, 8, 0), (0, 4, 0), (2, 8, 1)])
def test_refuses_unsupported(colour, depth, interlace):
    rows = np.zeros((2, 1 + 6), np.uint8)
    with pytest.raises(ValueError):
        decode_png(png_bytes(rows, np.zeros(2, int), 0, 8, 0)[:8].replace(b"PNG", b"JPG"))
    data = bytearray(png_bytes(rows, np.zeros(2, int), 0, 8))
    data[16:29] = struct.pack(">IIBBBBB", 2, 2, depth, colour, 0, 0, interlace)
    with pytest.raises(ValueError):
        decode_png(bytes(data))
