"""Port vs JAX and PIL: the port's own JPEG decoder (`native/jpeg.cc`).

`native.decode_jpeg` always goes through `jpeg.cc`, whether or not libjpeg
is present, and is held without tolerance (max abs diff 0) against the JAX
package's native decoder (libjpeg-turbo) and PIL (its own libjpeg-turbo):
  - on every committed fixture of `tests/data/torch_images/jpeg/`;
  - on JPEGs PIL encodes here from a seed, over size (1x1, 7x9, 17x33,
    239x317), subsampling, progressive, restart interval, quality and
    optimised tables;
  - on JPEGs `tests/torch_image_fixtures.encode_jpeg` writes with what PIL
    cannot: 4:4:0, 4:1:1, factors of 3 and mixed factors, extended
    sequential with 16-bit tables, RGB marked by its component ids;
  - on arithmetic-coded JPEGs that libjpeg's own compressor writes here
    (`tests/torch_libjpeg_writer.cc`), sequential and progressive, with
    restarts, sampling and conditioning parameters; `jpeg.cc`'s table of
    the arithmetic decoder's states equals libjpeg's `jpeg_aritab`;
  - the files the JAX decoder refuses (12-bit, lossless, hierarchical,
    CMYK, truncated headers) raise ValueError. Where libjpeg decodes what
    this decoder refuses, the test says so: entropy data cut short
    (libjpeg fills it with grey, PIL refuses);
  - `decode_batch` with the libjpeg route made unavailable equals the
    per-file decode, in threads.
"""

import io
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from megapose6d_tpu import native as jnative
from megapose6d_tpu_torch import native
from megapose6d_tpu_torch.utils.png import encode_png
from tests.torch_image_fixtures import OUT, encode_jpeg, encode_tiff, libjpeg_available, libjpeg_jpeg, pil_decode

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="jpeg.cc needs g++")
FIXTURES = sorted((OUT / "jpeg").glob("*.jpg"))


def _same(data: bytes) -> np.ndarray:
    """The port's decode, checked equal to PIL's and the JAX package's."""
    got = native.decode_jpeg(data)
    want = pil_decode(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.decode_image(data))
    return got


def _image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Smooth ramps with sharp noise on a third of the pixels: flat blocks,
    busy blocks, and values the IDCT clamps at both ends."""
    base = np.cumsum(rng.randint(-6, 7, (h, w, 3)), 1) + np.linspace(0, 90, h)[:, None, None] + 80
    spikes = rng.randint(-120, 121, (h, w, 3)) * (rng.rand(h, w, 1) < 0.3)
    return np.clip(base + spikes, 0, 255).astype(np.uint8)


def _pil(img: np.ndarray, **kw) -> bytes:
    """PIL's JPEG, with an output buffer large enough for a whole noisy
    frame (libjpeg cannot suspend mid-frame, which PIL's default buffer
    would ask of it)."""
    buf, block = io.BytesIO(), ImageFile.MAXBLOCK
    ImageFile.MAXBLOCK = max(block, 1 << 22)
    try:
        Image.fromarray(img).save(buf, "JPEG", **kw)
    finally:
        ImageFile.MAXBLOCK = block
    return buf.getvalue()


@pytest.mark.parametrize("path", FIXTURES, ids=[p.name for p in FIXTURES])
def test_fixture_matches_jax_and_pil(path):
    _same(path.read_bytes())


def test_fixtures_cover_the_formats():
    names = {p.name for p in FIXTURES}
    assert len(names) >= 12
    data = {p.name: p.read_bytes() for p in FIXTURES}
    assert b"Adobe" in data["adobe_rgb.jpg"] and b"JFIF" not in data["adobe_rgb.jpg"]
    assert b"Exif" in data["exif_420.jpg"]
    assert b"\xff\xc2" in data["progressive_grey.jpg"] and b"\xff\xc1" in data["mixed_extended_q16.jpg"]
    assert b"\xff\xdd" in data["restart_optimized_420.jpg"] and b"\xff\xdd" in data["411_q80_restart.jpg"]
    assert b"\xff\xc9" in data["arith_420_restart_239x317.jpg"] and b"\xff\xca" in data["arith_progressive_444.jpg"]
    assert _same(data["420_q95_480x640.jpg"]).shape == (480, 640, 3)
    assert _same(data["grey_q70.jpg"]).ndim == 2


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (239, 317)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_pil_encoded_matches(size, subsampling, progressive):
    rng = np.random.RandomState(size[0] * 100 + subsampling * 10 + progressive)
    img = _image(rng, *size)
    for quality in (50, 75, 90, 97):
        for restart in (0, 1, 4):
            data = _pil(img, quality=quality, subsampling=subsampling, progressive=progressive,
                        restart_marker_blocks=restart, optimize=restart == 4)
            _same(data)
    _same(_pil(img[..., 1], quality=85, progressive=progressive))  # grey


@pytest.mark.parametrize("sampling", [
    [(1, 2), (1, 1), (1, 1)],  # 4:4:0
    [(4, 1), (1, 1), (1, 1)],  # 4:1:1
    [(3, 1), (1, 1), (1, 1)],
    [(1, 3), (1, 1), (1, 1)],
    [(2, 2), (2, 1), (1, 2)],
    [(2, 2), (1, 2), (2, 2)],
    [(1, 1), (1, 1), (1, 1)],
    [(2, 1), (1, 1), (2, 1)],
], ids=["440", "411", "311", "131", "mixed", "mixed2", "444", "422b"])
def test_sampling_factors(sampling):
    rng = np.random.RandomState(len(str(sampling)))
    for h, w in ((1, 1), (5, 3), (9, 17), (33, 47), (64, 80)):
        img = _image(rng, h, w)
        _same(encode_jpeg(img, 85, sampling))
        _same(encode_jpeg(img, 60, sampling, restart=3))


@pytest.mark.parametrize("kind", ["extended_q16", "rgb_adobe", "rgb_ids", "grey_sampled", "exif"])
def test_encoder_variants(kind):
    rng = np.random.RandomState(5)
    img = _image(rng, 37, 51)
    data = {
        "extended_q16": lambda: encode_jpeg(img, 8, [(2, 2), (1, 1), (1, 1)], sof=0xC1, q16=True),
        "rgb_adobe": lambda: encode_jpeg(img, 90, [(1, 1), (1, 2), (1, 1)], rgb=True),
        "rgb_ids": lambda: encode_jpeg(img, 90, rgb="ids", jfif=False),
        "grey_sampled": lambda: encode_jpeg(img[..., 0], 80, [(2, 2)]),
        "exif": lambda: encode_jpeg(img, 80, app1=_exif()),
    }[kind]()
    _same(data)


def _exif() -> bytes:
    exif = Image.Exif()
    exif[0x0112] = 8  # an orientation, which both decoders ignore
    return exif.tobytes()


def _sof_patched(data: bytes, marker: int | None = None, precision: int | None = None) -> bytes:
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_image(np.random.RandomState(2), 16, 24)).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


BASE = encode_jpeg(_image(np.random.RandomState(4), 120, 160), 80, [(2, 2), (1, 1), (1, 1)])


@pytest.mark.parametrize("case, make, message", [
    ("12-bit", lambda: _sof_patched(BASE, precision=12), "precision 12"),
    ("lossless", lambda: _sof_patched(BASE, 0xC3), "lossless"),
    ("lossless arithmetic", lambda: _sof_patched(BASE, 0xCB), "lossless"),
    ("hierarchical", lambda: _sof_patched(BASE, 0xC5), "hierarchical"),
    ("cmyk", _cmyk, "4 components"),
    ("truncated header", lambda: BASE[:300], "marker length|premature"),
    ("not a jpeg", lambda: b"\xff\xd9" + BASE[2:], "not a JPEG"),
])
def test_refused_like_libjpeg(case, make, message):
    data = make()
    with pytest.raises(ValueError, match=message):
        native.decode_jpeg(data)
    if jnative.available():
        with pytest.raises(ValueError):
            jnative.decode_image(data)


def test_refused_where_libjpeg_guesses():
    """libjpeg decodes these with a warning; `jpeg.cc` refuses them."""
    sos = BASE.index(b"\xff\xda")
    cut = BASE[: (sos + len(BASE)) // 2]  # entropy data cut short: libjpeg fills with grey
    prog = _pil(_image(np.random.RandomState(6), 120, 160), progressive=True)
    for data in (cut, prog[: len(prog) - 300]):
        with pytest.raises(ValueError, match="premature end"):
            native.decode_jpeg(data)
        with pytest.raises(OSError):
            pil_decode(data)  # PIL refuses them too
        if jnative.available():
            assert jnative.decode_image(data).shape[:2] == (120, 160)
    if libjpeg_available():  # arithmetic data cut short
        arith = libjpeg_jpeg(_image(np.random.RandomState(9), 120, 160), 80)
        with pytest.raises(ValueError, match="premature end"):
            native.decode_jpeg(arith[: len(arith) // 2])


needs_libjpeg = pytest.mark.skipif(not libjpeg_available(), reason="the test writer needs libjpeg's headers")


@needs_libjpeg
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (239, 317)])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("grey", [False, True])
def test_arithmetic_matches_jax_and_pil(size, progressive, grey):
    rng = np.random.RandomState(size[1] + 2 * progressive + grey)
    img = _image(rng, *size)
    img = img[..., 0] if grey else img
    sampling = ([(1, 1)] if grey else [(2, 2), (1, 1), (1, 1)], [(2, 1)] if grey else [(1, 2), (1, 1), (1, 1)])
    for quality in (60, 95):
        for restart_rows in (0, 1):
            for dac in (None, (0, 4, 2), (3, 3, 30)):
                for s in sampling:
                    _same(libjpeg_jpeg(img, quality, progressive=progressive, restart_rows=restart_rows,
                                       sampling=s, dac=dac))


@needs_libjpeg
def test_arithmetic_state_table_is_libjpegs():
    import ctypes
    import ctypes.util
    import re

    lib = ctypes.CDLL(ctypes.util.find_library("jpeg"))
    want = list((ctypes.c_long * 114).in_dll(lib, "jpeg_aritab"))
    src = (Path(native.__file__).parent / "jpeg.cc").read_text()
    rows = re.findall(r"V\((\d+), (0x[0-9a-f]+), (\d+), (\d+), (\d)\)", src)
    got = [(int(qe, 16) << 16) | (int(mps) << 8) | (int(sw) << 7) | int(lps) for _, qe, lps, mps, sw in rows]
    assert [int(i) for i, *_ in rows] == list(range(114)) and got == want


def test_missing_eoi_decodes_like_libjpeg():
    prog = _pil(_image(np.random.RandomState(7), 30, 41), progressive=True)
    for data in (BASE[:-2], prog[:-2]):
        got = native.decode_jpeg(data)
        if jnative.available():
            np.testing.assert_array_equal(got, jnative.decode_image(data))


def test_decode_batch_without_libjpeg(monkeypatch):
    rng = np.random.RandomState(8)
    datas = [_pil(_image(rng, 20 + i, 30 + 2 * i), quality=70 + i, progressive=i % 2 == 1) for i in range(7)]
    datas += [encode_jpeg(_image(rng, 17, 9), 80, [(1, 2), (1, 1), (1, 1)]), encode_png(_image(rng, 5, 6)),
              encode_tiff(_image(rng, 8, 4)[..., 0], 5)]
    monkeypatch.setitem(native._libs, "decode", None)
    assert native.decoder() == "png.py + unfilter.cc, jpeg.cc"
    single = [native.decode_image(d) for d in datas]
    for a, d in zip(single[:8], datas):
        np.testing.assert_array_equal(a, native.decode_jpeg(d))
    for n_threads in (1, 3, 16):
        for a, b in zip(single, native.decode_batch(datas, n_threads=n_threads)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    bad = datas[:3] + [BASE[: len(BASE) - 400]]
    with pytest.raises(ValueError, match="premature end"):
        native.decode_batch(bad, n_threads=2)


def test_library_is_built_from_the_port():
    native.decode_jpeg(BASE)
    lib = native._libs["jpeg"]
    assert Path(lib._name).name.startswith("jpeg-") and Path(lib._name).parent == native.BUILD_DIR
