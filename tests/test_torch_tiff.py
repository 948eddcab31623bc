"""Port vs PIL: the port's TIFF reader (`utils/tiff.py`, its LZW and
PackBits strips in `native/tiff.cc`).

Held without tolerance against the values of `np.asarray(PIL.Image.open(...))`
(the JAX package reads TIFF through PIL; a big-endian 16-bit array of PIL
keeps the file's byte order, the port's is native, so values are compared):
  - on every committed fixture of `tests/data/torch_images/tiff/`, through
    `native.decode_image` (with `tiff.cc`) and `utils/tiff.decode_tiff`
    (its Python twins);
  - on TIFFs PIL writes here over compression, bit depth, byte order and
    predictor, and on TIFFs `tests/torch_image_fixtures.encode_tiff` writes
    over compression, byte order, bit depth, predictor, strips or tiles
    and WhiteIsZero;
  - the Python LZW and PackBits twins equal `tiff.cc`, on streams long
    enough to clear LZW's table, and cut short;
  - what the reader does not handle raises ValueError.
"""

import io
import shutil

import numpy as np
import pytest
from PIL import Image

from megapose6d_tpu_torch import native
from megapose6d_tpu_torch.utils import tiff
from tests.torch_image_fixtures import OUT, encode_tiff, lzw_encode, packbits_encode

FIXTURES = sorted((OUT / "tiff").glob("*.tif"))
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="tiff.cc needs g++")


def _same(data: bytes) -> np.ndarray:
    want = np.asarray(Image.open(io.BytesIO(data)))
    for got in (native.decode_image(data), tiff.decode_tiff(data)):
        assert got.dtype == want.dtype.newbyteorder("=") and got.shape == want.shape
        assert got.dtype.isnative
        np.testing.assert_array_equal(got, want)
    return want


def _image(rng: np.random.RandomState, h: int, w: int, depth: int = 8, channels: int = 1) -> np.ndarray:
    top = (1 << depth) - 1
    base = np.cumsum(rng.randint(-3, 4, (h, w, channels)) * (top // 255), 1) + top // 2
    img = np.clip(base + (rng.rand(h, w, 1) < 0.1) * rng.randint(-top // 3, top // 3, (h, w, channels)), 0, top)
    img = img.astype(np.uint16 if depth == 16 else np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("path", FIXTURES, ids=[p.name for p in FIXTURES])
def test_fixture_matches_pil(path):
    _same(path.read_bytes())


def test_fixtures_cover_the_formats():
    assert len(FIXTURES) >= 8
    fields = {p.name: tiff._fields(p.read_bytes()) for p in FIXTURES}
    seen = {(order, f[259][0], f.get(317, (1,))[0], f[258][0], 324 in f, f[262][0]) for order, f in fields.values()}
    assert {s[0] for s in seen} == {"<", ">"} and {s[1] for s in seen} >= {1, 5, 8, 32773}
    assert any(s[2] == 2 for s in seen) and {s[3] for s in seen} == {8, 16}
    assert any(s[4] for s in seen) and any(s[5] == 0 for s in seen)


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["L", "I;16", "I;16B", "RGB"])
@pytest.mark.parametrize("predictor", [1, 2])
def test_pil_written(compression, mode, predictor):
    rng = np.random.RandomState(len(mode) * 7 + predictor)
    for h, w in ((1, 1), (13, 7), (67, 45)):
        img = _image(rng, h, w, 16 if mode.startswith("I") else 8, 3 if mode == "RGB" else 1)
        im = Image.fromarray(img)
        if mode == "I;16B":
            im = Image.frombytes(mode, (w, h), img.astype(">u2").tobytes())
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression=compression, tiffinfo={317: predictor} if predictor > 1 else {})
        np.testing.assert_array_equal(_same(buf.getvalue()), img)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("depth", [8, 16])
def test_written_here(compression, order, depth):
    rng = np.random.RandomState(compression + depth)
    for h, w in ((1, 1), (20, 33), (70, 90)):
        img = _image(rng, h, w, depth)
        for predictor in ((1, 2) if compression in (5, 8) else (1,)):
            for layout in ({}, {"rows_per_strip": 7}, {"tile": (32, 16)}):
                np.testing.assert_array_equal(_same(encode_tiff(img, compression, order, predictor, **layout)), img)
        if depth == 8:
            _same(encode_tiff(img, compression, order, white_is_zero=True, rows_per_strip=5))
            rgb = _image(rng, h, w, 8, 3)
            np.testing.assert_array_equal(_same(encode_tiff(rgb, compression, order, tile=(16, 16))), rgb)


@needs_gxx
def test_python_twins_equal_tiff_cc():
    rng = np.random.RandomState(11)
    streams = [b"", b"a", bytes(rng.randint(0, 4, 20000).astype(np.uint8)),  # runs: the table clears
               bytes(rng.randint(0, 256, 9000).astype(np.uint8)), b"abababababababab" * 500]
    for raw in streams:
        for name, encode, twin in (("lzw", lzw_encode, tiff.lzw_decode),
                                   ("packbits", packbits_encode, tiff.packbits_decode)):
            enc = encode(raw)
            for size in (len(raw), len(raw) // 2, len(raw) + 5):
                a, b = twin(enc, size), native._strips(name, enc, size)
                assert a == b == raw[:size], (name, len(raw), size)
            cut = enc[: len(enc) // 2]
            assert twin(cut, len(raw)) == native._strips(name, cut, len(raw))
    bad = bytes([0x80, 0x4F, 0xFF, 0xFF])  # a clear, then a code not yet defined
    with pytest.raises(ValueError, match="LZW"):
        tiff.lzw_decode(bad, 10)
    with pytest.raises(ValueError, match="LZW"):
        native._strips("lzw", bad, 10)


def _with_tag(data: bytes, tag: int, value: int) -> bytes:
    """`data` with the SHORT or LONG value of `tag` in its first directory replaced."""
    order, _ = tiff._fields(data)
    out = bytearray(data)
    (ifd,) = np.frombuffer(data[4:8], order + "u4")
    (n,) = np.frombuffer(data[ifd : ifd + 2], order + "u2")
    for i in range(n):
        at = ifd + 2 + 12 * i
        t, kind = np.frombuffer(data[at : at + 4], order + "u2")
        if t == tag:
            out[at + 8 : at + 12] = np.array([value], order + ("u2" if kind == 3 else "u4")).tobytes().ljust(4, b"\0")
            return bytes(out)
    raise KeyError(tag)


@pytest.mark.parametrize("case", ["bilevel", "rgba", "float", "jpeg-compressed", "predictor 3", "16-bit inverted",
                                  "planar", "truncated", "bigtiff"])
def test_refused(case):
    rng = np.random.RandomState(3)
    grey = _image(rng, 9, 11)
    if case == "bilevel":
        buf = io.BytesIO()
        Image.fromarray(grey > 128).save(buf, "TIFF")
        data = buf.getvalue()
    elif case == "rgba":
        buf = io.BytesIO()
        Image.fromarray(np.dstack([_image(rng, 9, 11, 8, 3), grey])).save(buf, "TIFF")
        data = buf.getvalue()
    elif case == "float":
        buf = io.BytesIO()
        Image.fromarray(grey.astype(np.float32)).save(buf, "TIFF")
        data = buf.getvalue()
    elif case == "jpeg-compressed":
        data = _with_tag(encode_tiff(grey), 259, 7)
    elif case == "predictor 3":
        data = _with_tag(encode_tiff(grey, 8, predictor=2), 317, 3)
    elif case == "16-bit inverted":
        data = _with_tag(encode_tiff(grey.astype(np.uint16)), 262, 0)
    elif case == "planar":
        data = _with_tag(encode_tiff(_image(rng, 9, 11, 8, 3)), 284, 2)
    elif case == "truncated":
        data = encode_tiff(grey, 8)
        data = data[:12] + data[12:40]  # the strip cut short, the directory lost
    else:
        data = b"II+\0" + bytes(12)
    with pytest.raises(ValueError):
        tiff.decode_tiff(data)
    with pytest.raises(ValueError):
        native.decode_image(data)
