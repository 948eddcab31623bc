"""Port vs JAX: the host C++ of the input pipeline (`native/`).

The port builds its own copies of `decode.cc` and `meshproc.cc` into
`build/` (never the JAX package's libraries). Held without tolerance:
  - `decode_image` / `decode_batch` equal `utils/png.py`, the JAX
    package's native decoder and PIL on 8-bit grey, RGB, RGBA and 16-bit
    grey PNGs, and the JAX package's native decoder on JPEG;
  - without the native library, PNGs go through `utils/png.py` (its rows
    unfiltered by `unfilter.cc`, equal to its numpy unfilter on every
    filter type, or by numpy without a compiler) and a JPEG through
    `jpeg.cc`, equal to the JAX package's native decoder (more in
    `test_torch_jpeg.py`);
  - `simplify_mesh` and `meshes/io.simplify_vertex_clustering` equal the
    JAX package's native decimation vertex for vertex and face for face.
The native tests skip, with a reason, where g++ (or libpng/libjpeg) is
missing.
"""

import io
import shutil

import numpy as np
import pytest
from PIL import Image

from megapose6d_tpu import native as jnative
from megapose6d_tpu.meshes import io as jio
from megapose6d_tpu_torch import native
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.ops._nvcc import BUILD_DIR
from megapose6d_tpu_torch.utils.png import decode_png, unfilter

needs_decoder = pytest.mark.skipif(shutil.which("g++") is None or not native.available(),
                                   reason="the native decoder needs g++, libpng and libjpeg")
needs_meshproc = pytest.mark.skipif(shutil.which("g++") is None or not native.meshproc_available(),
                                    reason="the native decimator needs g++")


def _encoded(kind: str, seed: int) -> tuple[bytes, np.ndarray]:
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 70, 2)
    arr = {
        "grey": lambda: rng.randint(0, 256, (h, w)).astype(np.uint8),
        "rgb": lambda: rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
        "rgba": lambda: rng.randint(0, 256, (h, w, 4)).astype(np.uint8),
        "grey16": lambda: rng.randint(0, 65536, (h, w)).astype(np.uint16),
        "jpeg": lambda: np.clip(np.cumsum(rng.randint(-9, 10, (h, w, 3)), 1) + 128, 0, 255).astype(np.uint8),
    }[kind]()
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG" if kind == "jpeg" else "PNG")
    return buf.getvalue(), arr


@needs_decoder
@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "grey16", "jpeg"])
def test_decode_matches_png_py_jax_and_pil(kind):
    datas = [_encoded(kind, s)[0] for s in range(4)]
    got = [native.decode_image(d) for d in datas]
    for d, g in zip(datas, got):
        want = np.asarray(Image.open(io.BytesIO(d)))
        assert g.dtype == want.dtype and g.shape == want.shape
        if kind != "jpeg":  # PIL's own libjpeg may round its IDCT differently
            np.testing.assert_array_equal(g, want)
            np.testing.assert_array_equal(g, decode_png(d))
        if jnative.available():
            np.testing.assert_array_equal(g, jnative.decode_image(d))
    for g, b in zip(got, native.decode_batch(datas, n_threads=2)):
        np.testing.assert_array_equal(g, b)


def test_decoder_library_is_the_ports_own():
    if native.available():
        assert native.decoder() == "native"
        assert native._libs["decode"]._name.startswith(str(BUILD_DIR))
    else:
        assert native.decoder().startswith("png.py")


@pytest.mark.parametrize("unfilter_lib", ["built", "missing"])
def test_fallback_without_the_library(monkeypatch, unfilter_lib):
    monkeypatch.setitem(native._libs, "decode", None)
    if unfilter_lib == "missing":
        monkeypatch.setitem(native._libs, "unfilter", None)
    elif native._load("unfilter") is None:
        pytest.skip("unfilter.cc did not build (no g++)")
    assert not native.available()
    jpeg = ", jpeg.cc" if native._load("jpeg") is not None else ""
    assert native.decoder() == ("png.py + unfilter.cc" if unfilter_lib == "built" else "png.py") + jpeg
    for kind in ("grey", "rgb", "rgba", "grey16"):
        data, arr = _encoded(kind, 7)
        np.testing.assert_array_equal(native.decode_image(data), arr)
        np.testing.assert_array_equal(native.decode_batch([data])[0], arr)
    data = _encoded("jpeg", 7)[0]
    if not jpeg:
        with pytest.raises(RuntimeError, match="JPEG"):
            native.decode_image(data)
    elif jnative.available():
        np.testing.assert_array_equal(native.decode_image(data), jnative.decode_image(data))
        np.testing.assert_array_equal(native.decode_batch([data, data])[1], jnative.decode_image(data))


@pytest.mark.skipif(shutil.which("g++") is None, reason="unfilter.cc needs g++")
def test_unfilter_matches_png_py():
    rng = np.random.RandomState(3)
    for bpp in (1, 2, 3, 4, 6, 8):
        for h, w in ((1, 1), (7, 1), (1, 9), (23, 31)):
            filtered = rng.randint(0, 256, (h, w, bpp)).astype(np.uint8)
            ftype = rng.randint(0, 5, h).astype(np.uint8)
            np.testing.assert_array_equal(native.unfilter(filtered, ftype), unfilter(filtered, ftype))


MESHES = {
    "sphere_colored": lambda: jio.make_uv_sphere(0.05, 48, 48),
    "sphere_small": lambda: jio.make_uv_sphere(0.03, 20, 28),
    "cube_textured": lambda: jio.make_cube(0.04, textured=True, seed=3),
    "cylinder": lambda: jio.make_cylinder(0.025, 0.09, n_seg=64),
}


@needs_meshproc
@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("target", [40, 300, 1000])
def test_decimation_matches_jax_native(name, target):
    if not jnative.meshproc_available():
        pytest.skip("the JAX package's native decimator did not build")
    mesh = MESHES[name]()
    for colors in (mesh.vertex_colors, None):
        a = jnative.simplify_mesh(mesh.vertices, mesh.faces, colors, target)
        b = native.simplify_mesh(mesh.vertices, mesh.faces, colors, target)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    ja = jio.simplify_vertex_clustering(mesh, target)
    tb = tio.simplify_vertex_clustering(tio.TriMesh(mesh.vertices, mesh.faces, vertex_colors=mesh.vertex_colors,
                                                    vertex_normals=mesh.vertex_normals), target)
    assert 0 < tb.n_faces <= target if mesh.n_faces > target else tb.n_faces == mesh.n_faces
    for k in ("vertices", "faces", "vertex_colors", "vertex_normals"):
        np.testing.assert_array_equal(getattr(ja, k), getattr(tb, k), err_msg=k)
