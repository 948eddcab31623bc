"""Port vs PIL and libpng: the port's PNG decoder on every committed PNG of
the BOP test sets (textures, RGB frames, 16-bit depth, masks) against PIL,
bit for bit; on every layout libpng reads (palettes at 1-8 bits, tRNS on
palette, RGB and grey, 1/2/4-bit grey, grey with alpha, Adam7) against the
JAX package's native decoder (libpng as `decode.cc` configures it), through
`decode_png` and `native.decode_image` / `decode_batch` with the native
library forced off (rows unfiltered by `unfilter.cc` or numpy) and with it
built; on random images of each layout written by PIL (or, for what PIL
does not write, by `tests/torch_image_fixtures.encode_png_any`) against the
array libpng must give; and on malformed files, which both refuse or both
read alike."""

import io
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from megapose6d_tpu import native as jnative
from megapose6d_tpu_torch import native
from megapose6d_tpu_torch.utils.png import decode_png, read_png, unfilter
from tests.torch_image_fixtures import OUT, encode_png_any, png_chunk

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


needs_libpng = pytest.mark.skipif(shutil.which("g++") is None or not jnative.available(),
                                  reason="the JAX package's native decoder (the reference) needs g++ and libpng")
FIXTURES = sorted(str(p.relative_to(OUT)) for d in ("png", "textures") for p in (OUT / d).glob("*.png"))
ROUTES = ("decode_png", "png.py + unfilter.cc", "png.py", "decode.cc")


def _route(monkeypatch, route):
    """`decode_png` itself, or `native.decode_image` / `decode_batch` with
    the native decoder forced off (unfilter.cc built, or missing: numpy
    unfilters) or built."""
    if route == "decode_png":
        return decode_png, lambda datas, n_threads=0: [decode_png(d) for d in datas]
    if route == "decode.cc":
        if not native.available():
            pytest.skip("decode.cc did not build (no libpng)")
        return native.decode_image, native.decode_batch
    monkeypatch.setitem(native._libs, "decode", None)
    if route == "png.py":
        monkeypatch.setitem(native._libs, "unfilter", None)
    elif native._load("unfilter") is None:
        pytest.skip("unfilter.cc did not build (no g++)")
    assert native.decoder().startswith(route)
    return native.decode_image, native.decode_batch


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@needs_libpng
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("rel", FIXTURES)
def test_every_layout_matches_libpng(monkeypatch, rel, route):
    data = (OUT / rel).read_bytes()
    want = jnative.decode_image(data)
    one, batch = _route(monkeypatch, route)
    _same(one(data), want)
    for got in batch([data, data], n_threads=2):
        _same(got, want)


def _pil_png(im) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def _random_case(kind: str, h: int, w: int, seed: int) -> tuple[bytes, np.ndarray]:
    """A random `h x w` PNG of layout `kind` and the array libpng gives for
    it, worked out from the pixels written: PIL writes the layouts it
    writes (palettes, which it packs to 1, 2 or 4 bits when they are
    small, with tRNS; 1-bit grey; grey and RGB with a tRNS colour; grey
    with alpha; 16-bit grey), `encode_png_any` the others (2- and 4-bit
    grey, Adam7)."""
    rng = np.random.RandomState(seed)
    if kind.startswith(("palette", "adam7_palette")):
        k = rng.randint(1, 257) if kind != "adam7_palette" else rng.randint(1, 5)
        pal = rng.randint(0, 256, (k, 3)).astype(np.uint8)
        idx = rng.randint(0, k, (h, w)).astype(np.uint8)
        trns = bytes(rng.randint(0, 256, rng.randint(1, k + 1)).astype(np.uint8)) if "trns" in kind or \
            kind == "adam7_palette" else None
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
        want = pal[idx] if trns is None else np.concatenate([pal[idx], alpha[idx][..., None]], -1)
        if kind == "adam7_palette":
            return encode_png_any(idx, 3, 2 if k > 2 else 1, palette=pal, trns=trns, interlace=1, seed=seed), want
        im = Image.fromarray(idx, "P")
        im.putpalette(pal.reshape(-1).tolist())
        if trns is not None:
            im.info["transparency"] = trns
        return _pil_png(im), want
    if kind in ("grey1", "grey1_trns", "adam7_grey1"):
        bits = rng.randint(0, 2, (h, w)).astype(bool)
        want = bits.astype(np.uint8) * 255
        if kind == "adam7_grey1":
            return encode_png_any(bits, 0, 1, interlace=1, seed=seed), want
        im = Image.fromarray(bits)
        if kind == "grey1_trns":
            key = int(rng.randint(0, 2))
            im.info["transparency"] = key
            want = np.stack([want, np.where(bits == key, 0, 255).astype(np.uint8)], -1)
        return _pil_png(im), want
    if kind in ("grey2", "grey4", "grey4_trns"):
        depth = int(kind[4])
        g = rng.randint(0, 1 << depth, (h, w))
        want = (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
        trns = None
        if kind.endswith("trns"):
            key = int(g[rng.randint(h), rng.randint(w)])
            trns = struct.pack(">H", key)
            want = np.stack([want, np.where(g == key, 0, 255).astype(np.uint8)], -1)
        return encode_png_any(g, 0, depth, trns=trns, seed=seed), want
    if kind in ("grey8_trns", "rgb_trns"):
        img = rng.randint(0, 256, (h, w) if kind == "grey8_trns" else (h, w, 3)).astype(np.uint8)
        key = img[rng.randint(h), rng.randint(w)]
        im = Image.fromarray(img)
        im.info["transparency"] = int(key) if img.ndim == 2 else tuple(int(v) for v in key)
        hit = img == key if img.ndim == 2 else (img == key).all(-1)
        want = np.concatenate([img.reshape(h, w, -1), np.where(hit, 0, 255).astype(np.uint8)[..., None]], -1)
        return _pil_png(im), want
    if kind == "grey_alpha":
        img = rng.randint(0, 256, (h, w, 2)).astype(np.uint8)
        return _pil_png(Image.fromarray(img, "LA")), img
    if kind == "grey16":
        img = rng.randint(0, 65536, (h, w)).astype(np.uint16)
        return _pil_png(Image.fromarray(img)), img
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)  # adam7_rgb
    return encode_png_any(img, 2, 8, interlace=1, seed=seed), img


KINDS = ("palette", "palette_trns", "adam7_palette", "rgb_trns", "grey1", "grey1_trns", "adam7_grey1", "grey2",
         "grey4", "grey4_trns", "grey8_trns", "grey_alpha", "grey16", "adam7_rgb")


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=25, derandomize=True, deadline=None, database=None)
@given(h=st.integers(1, 17), w=st.integers(1, 17), seed=st.integers(0, 2**31 - 1))
def test_random_layouts_round_trip(kind, h, w, seed):
    data, want = _random_case(kind, h, w, seed)
    _same(decode_png(data), want)
    if jnative.available():
        _same(jnative.decode_image(data), want)


def _malformed() -> dict[str, bytes]:
    """Files libpng refuses, or reads while warning, built from one valid
    palette PNG with tRNS and one RGB PNG."""
    rng = np.random.RandomState(5)
    pal, idx = rng.randint(0, 256, (5, 3)), rng.randint(0, 5, (4, 6))
    ihdr, plte, trns, idat, iend = _parts(encode_png_any(idx, 3, 8, palette=pal, trns=bytes([10, 20])))
    rgb_ihdr, rgb_idat, _ = _parts(encode_png_any(rng.randint(0, 256, (4, 6, 3)), 2, 8))
    raw = zlib.decompress(idat[1])
    z = zlib.compress(raw)
    idx[0, :2] = (9, 255)  # past the palette's end
    return {
        "index past the palette": encode_png_any(idx, 3, 8, palette=pal, trns=bytes([10, 20])),
        "tRNS longer than the palette": _png(ihdr, plte, (b"tRNS", bytes(6)), idat, iend),
        "tRNS before PLTE": _png(ihdr, trns, plte, idat, iend),
        "tRNS after IDAT": _png(ihdr, plte, idat, trns, iend),
        "two tRNS": _png(ihdr, plte, trns, (b"tRNS", b"\1"), idat, iend),
        "no PLTE": _png(ihdr, idat, iend),
        "PLTE after IDAT": _png(ihdr, idat, plte, iend),
        "two PLTE": _png(ihdr, plte, plte, idat, iend),
        "empty PLTE": _png(ihdr, (b"PLTE", b""), idat, iend),
        "PLTE not of whole entries": _png(ihdr, (b"PLTE", plte[1][:-1]), idat, iend),
        "IHDR CRC": _png(ihdr, plte, idat, iend, bad_crc=0),
        "PLTE CRC": _png(ihdr, plte, idat, iend, bad_crc=1),
        "tRNS CRC": _png(ihdr, plte, trns, idat, iend, bad_crc=2),
        "IDAT CRC": _png(ihdr, plte, idat, iend, bad_crc=2),
        "IEND CRC": _png(ihdr, plte, idat, iend, bad_crc=3),
        "no IEND": _png(ihdr, plte, idat),
        "unknown critical chunk": _png(ihdr, plte, (b"ABCD", b"xx"), idat, iend),
        "unknown ancillary chunk": _png(ihdr, plte, (b"abCD", b"xx"), idat, iend),
        "unknown critical chunk after IDAT": _png(ihdr, plte, idat, (b"ABCD", b"xx"), iend),
        "image data short": _png(ihdr, plte, (b"IDAT", zlib.compress(raw[:-1])), iend),
        "image data long": _png(ihdr, plte, (b"IDAT", zlib.compress(raw + b"\0\0\0")), iend),
        "IDAT split": _png(ihdr, plte, (b"IDAT", z[:5]), (b"IDAT", z[5:]), iend),
        "IDAT split by a chunk": _png(ihdr, plte, (b"IDAT", z[:5]), (b"teXt", b"a\0b"), (b"IDAT", z[5:]), iend),
        "bytes after the zlib stream": _png(ihdr, plte, (b"IDAT", z + b"junk"), iend),
        "zlib stream cut short": _png(ihdr, plte, (b"IDAT", z[:-4]), iend),
        "bad row filter": _png(ihdr, plte, (b"IDAT", zlib.compress(bytes([7]) + raw[1:])), iend),
        "IHDR compression 1": _png((b"IHDR", ihdr[1][:10] + b"\1" + ihdr[1][11:]), plte, idat, iend),
        "IHDR interlace 2": _png((b"IHDR", ihdr[1][:12] + b"\2"), plte, idat, iend),
        "RGB at 4 bits": _png((b"IHDR", ihdr[1][:8] + b"\4\2" + ihdr[1][10:]), plte, idat, iend),
        "width 0": _png((b"IHDR", bytes(4) + ihdr[1][4:]), plte, idat, iend),
        "IHDR not first": _png(plte, ihdr, idat, iend),
        "RGB with PLTE": _png(rgb_ihdr, plte, rgb_idat, iend),
        "RGB with an invalid PLTE": _png(rgb_ihdr, (b"PLTE", b"\1"), rgb_idat, iend),
        "RGB with tRNS before PLTE": _png(rgb_ihdr, (b"tRNS", bytes(6)), plte, rgb_idat, iend),
    }


def _parts(data: bytes) -> list[tuple[bytes, bytes]]:
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        out.append((data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]))
        pos += 12 + n
    return out


def _png(*chunks, bad_crc: int = -1) -> bytes:
    out = b"\x89PNG\r\n\x1a\n"
    for i, (kind, body) in enumerate(chunks):
        c = png_chunk(kind, body)
        out += c[:-1] + bytes([c[-1] ^ 1]) if i == bad_crc else c
    return out


@needs_libpng
@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformed_like_libpng(case):
    """Refused by both or read by both to the same array."""
    data = _malformed()[case]

    def outcome(fn):
        try:
            return fn(data)
        except ValueError:
            return None

    want, got = outcome(jnative.decode_image), outcome(decode_png)
    assert (want is None) == (got is None), (want, got)
    if want is not None:
        _same(got, want)


@pytest.mark.parametrize("colour", [2, 4, 6])
def test_refuses_16_bit_colour(monkeypatch, colour):
    """Valid 16-bit RGB, grey with alpha and RGBA: `decode.cc` refuses
    them for their format alone, and so does the port on every route."""
    img = np.random.RandomState(colour).randint(0, 65536, (5, 7, {2: 3, 4: 2, 6: 4}[colour]))
    data = encode_png_any(img, colour, 16)
    if native.available():
        with pytest.raises(ValueError):
            native.decode_image(data)
    if jnative.available():
        with pytest.raises(ValueError):
            jnative.decode_image(data)
    with pytest.raises(ValueError, match="16 bits"):
        decode_png(data)
    monkeypatch.setitem(native._libs, "decode", None)
    with pytest.raises(ValueError, match="16 bits"):
        native.decode_image(data)
