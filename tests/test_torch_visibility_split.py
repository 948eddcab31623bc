"""Phase B with each tile's chain of chunks split into parts, on the CPU.

On the card a launch with few tiles gives each tile a cluster of `split`
blocks; block s walks the s-th part of the tile's active chunks and keeps
per pixel the best 1/z and its face id, and the parts fold in order, a
strictly larger 1/z replacing (`csrc/visibility.cu`). `visibility_plain(...,
split=S)` is that split and merge in torch. Here it is held bit for bit
against the whole walk (`split=1`) and, at the tolerances of
`tests/test_torch_rasterizer.py`, against the JAX package's Pallas kernel
(interpreted), on tables with ties of 1/z across the parts' boundaries
(every face twice, the copies in neighbouring chunks of each list), a chunk
whose 1/z planes are NaN, tiles with no active chunk and tiles whose chain
is shorter than `split` (which one block walks whole). The 16-face chunk is a constant:
a model config that names another is refused, and the committed runs'
configs load.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megapose6d_tpu.meshes import make_uv_sphere
from megapose6d_tpu.ops import rasterizer_tiled as jrt
from megapose6d_tpu_torch.interop.from_jax import config_from_run_json
from megapose6d_tpu_torch.models.pose_predictor import PosePredictorConfig
from megapose6d_tpu_torch.ops import rasterizer_tiled as trt
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.training.config import load_config

pin_f32()
ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 128
K = np.asarray([[220.0, 0, W / 2 - 0.5], [0, 220.0, H / 2 - 0.5], [0, 0, 1]], np.float32)
SPLITS = [1, 2, 3, 7]
NAN_CHUNK = 15  # the first copy of this chunk gets NaN 1/z planes


def scene():
    """Screen-space inputs of 3 images: a UV sphere whose face list is
    repeated (chunk c and chunk c + n of the doubled list hold the same
    faces), in the third image only its first chunk valid."""
    mesh = make_uv_sphere(0.04, 12, 16)
    F = -(-mesh.n_faces // 16) * 16
    faces = np.pad(mesh.faces, ((0, F - mesh.n_faces), (0, 0)))
    valid = np.arange(F) < mesh.n_faces
    B = 3
    TCO = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    TCO[:, :3, 3] = [[0.004, -0.003, 0.33], [0.05, 0.006, 0.7], [0.0, 0.0, 0.35]]
    for b, ang in ((1, 0.7), (2, np.pi / 2)):
        c, s = np.cos(ang), np.sin(ang)
        TCO[b, :3, :3] = [[1, 0, 0], [0, c, -s], [0, s, c]]
    rep = lambda a: np.repeat(np.asarray(a)[None], B, 0)
    screen = trt.project_to_screen(torch.as_tensor(rep(mesh.vertices)), torch.as_tensor(TCO),
                                   torch.as_tensor(rep(K))).numpy()
    fv = np.concatenate([rep(valid)] * 2, 1)
    fv[2] = False  # image 2: one chunk (and its copy), its chains of 2
    fv[2, :16] = fv[2, F : F + 16] = True
    return (screen, rep(mesh.vertex_normals), rep(mesh.vertex_colors), np.concatenate([rep(faces)] * 2, 1),
            fv), F


def with_nan(coefs):
    coefs[:, NAN_CHUNK * 16 : (NAN_CHUNK + 1) * 16, 9:12] = np.nan
    return coefs


@pytest.fixture(scope="module")
def tables():
    args, F = scene()
    coefs, ids, n_act = trt.prepare(*map(torch.as_tensor, args), (H, W), 0.01)
    return (with_nan(coefs), ids, n_act), F


@pytest.fixture(scope="module")
def whole(tables):
    return trt.visibility_plain(*tables[0], (H, W))


@pytest.fixture(scope="module")
def jax_images():
    """The JAX package's own phase A and Pallas kernel (interpreted) on the
    same inputs and the same NaN chunk, as images."""
    args, _ = scene()
    coefs, ids, n_act = jax.vmap(lambda *a: jrt._prepare_single(*a, (H, W), 16, 0.01))(*map(jnp.asarray, args))
    coefs = jnp.asarray(with_nan(np.array(coefs)))
    invz, fid, attr = jrt._run_visibility(coefs, ids, n_act, 1, chunk=16, interpret=True)
    n_th = H // jrt.TILE_H
    to_img = lambda x: np.asarray(jrt._tiles_to_image(x, n_th, 1, H, W, jrt.TILE_H))
    attr = np.asarray(attr).reshape(3, n_th, 6, jrt.TILE_H, W)
    return to_img(invz), to_img(fid), np.stack([to_img(attr[:, :, k]) for k in range(6)], -1)


def test_tables_hold_the_cases(tables):
    """Each chunk's copy follows it in the lists (a tie of 1/z at every
    pixel it covers), the splits cut such pairs, the NaN chunk is active,
    some tiles have no active chunk and some chains are shorter than 7
    (and so are walked whole at split 7)."""
    (coefs, ids, n_act), F = tables
    n_c = F // 16
    chains = [ids[b, t, : n_act[b, t]].tolist() for b, t in zip(*torch.nonzero(n_act > 0, as_tuple=True))]
    for chain in chains:
        first = [c for c in chain if c < n_c]
        assert sorted(chain) == sorted(first + [c + n_c for c in first])
        assert all(chain.index(c) < chain.index(c + n_c) for c in first)
    for k in SPLITS[1:]:  # a boundary between a chunk and its copy, in a chain long enough to split
        assert any(ch[s * len(ch) // k] == ch[s * len(ch) // k - 1] + n_c
                   for ch in chains if len(ch) >= k for s in range(1, k)), k
    assert any(NAN_CHUNK in ch for ch in chains)
    n = n_act[n_act > 0]
    assert (n_act == 0).any() and ((n > 0) & (n < 7)).any() and (n >= 14).any()


@pytest.mark.parametrize("split", SPLITS)
def test_split_equals_the_whole_walk(tables, whole, split):
    """Bit for bit the walk through the whole chain."""
    out = trt.visibility_plain(*tables[0], (H, W), split)
    for a, b in zip(out, whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("split", SPLITS)
def test_split_ties_go_to_the_earlier_chunk(tables, split):
    """A tie of 1/z across two parts goes to the earlier part's chunk, as
    in the walk: the first copy of each face wins wherever it covers,
    except where its chunk is void (the NaN chunk's pixels go to its
    copy)."""
    (coefs, ids, n_act), F = tables
    fid = trt.visibility_plain(coefs, ids, n_act, (H, W), split)[1]
    hit = fid >= 0
    copy = fid >= F
    assert hit.flatten(1).any(1).all()
    assert bool(((fid // 16)[copy] == NAN_CHUNK + F // 16).all()) and copy.any()


@pytest.mark.parametrize("split", SPLITS)
def test_split_nan_chunk_voids_only_itself(tables, whole, split):
    """With the NaN chunk's planes made finite again, only its pixels
    change: they go back to its first copy."""
    (coefs, ids, n_act), F = tables
    finite = coefs.clone()
    finite[:, NAN_CHUNK * 16 : (NAN_CHUNK + 1) * 16, 9:12] = finite[:, F + NAN_CHUNK * 16 : F + (NAN_CHUNK + 1) * 16,
                                                                   9:12]
    fid_nan = trt.visibility_plain(coefs, ids, n_act, (H, W), split)[1]
    fid_fin = trt.visibility_plain(finite, ids, n_act, (H, W), split)[1]
    moved = fid_nan != fid_fin
    assert moved.any()
    assert torch.equal(fid_fin[moved] + F, fid_nan[moved]) and not (fid_fin >= F).any()
    assert torch.equal(fid_nan, whole[1])


@pytest.mark.parametrize("split", SPLITS)
def test_split_matches_jax(tables, jax_images, split):
    """Against the JAX package's kernel, at test_torch_rasterizer's
    tolerances: face ids everywhere, 1/z and attributes to f32 rounding."""
    invz, fid, attr = trt.visibility_plain(*tables[0], (H, W), split)
    invz_j, fid_j, attr_j = jax_images
    np.testing.assert_array_equal(fid_j, fid.numpy())
    np.testing.assert_allclose(invz_j, invz.numpy(), rtol=1e-6)
    np.testing.assert_allclose(attr_j, attr.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_tiles,n_chunks,split", [
    (576 * 150, 96, 1),  # the coarse sweep: many tiles, one block each
    (128 * 150, 96, 1),  # a coarse training batch of 128
    (64 * 150, 96, 1),  # a refiner training batch of 64
    (32 * 150, 96, 3),  # a detector training batch of 32 scenes
    (20 * 150, 96, 3),  # the refiner
    (2 * 150, 96, 8),  # a VSD render, 240x320
    (2 * 40, 96, 16),  # a depth-refiner render, 120x160
    (2 * 40, 3, 3),  # never more parts than chunks
    (1, 1, 1),
])
def test_split_for_launch_shapes(n_tiles, n_chunks, split):
    assert trt.split_for(n_tiles, n_chunks) == split


def test_other_chunk_sizes_are_refused(tmp_path):
    """16 faces a chunk in the kernel's phases on every device: phase A
    refuses a face count that is not a multiple of 16, and phase B on the
    CPU chunk lists that count chunks of another size. A model config
    takes the JAX package's chunk and pack options (any positive value,
    directly or in a run's config.json; they change no pixel) and passes
    them to the renderer, which keeps its 16-face chunk; 0 raises."""
    for bad in (dict(tile_face_chunk=0), dict(tile_hyp_pack=0)):
        with pytest.raises(ValueError, match="tile_"):
            PosePredictorConfig(**bad)
    assert PosePredictorConfig(tile_face_chunk=8).tile_face_chunk == 8
    assert PosePredictorConfig().tile_face_chunk == trt.FACE_CHUNK == 16
    d = json.loads((ROOT / "runs/refiner_dr/config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps({**d, "tile_face_chunk": 32}))
    assert config_from_run_json(tmp_path / "config.json")[0].tile_face_chunk == 32
    mesh = make_uv_sphere(0.04, 12, 16)
    T = torch.eye(4)[None]
    T[0, 2, 3] = 0.4
    args = [torch.as_tensor(a)[None] for a in (mesh.vertices, mesh.vertex_normals, mesh.vertex_colors, mesh.faces,
                                                np.ones(mesh.n_faces, bool))]
    with pytest.raises(ValueError, match="chunk"):
        trt.render_meshes_tiled(*args, T, torch.as_tensor(K)[None], (H, W), chunk=0)
    screen, n, c, f, fv = scene()[0]
    with pytest.raises(ValueError, match="multiple"):
        trt.prepare(*map(torch.as_tensor, (screen, n, c, f[:, 8:], fv[:, 8:])), (H, W), 0.01)
    coefs, ids, n_act = trt.prepare(*map(torch.as_tensor, (screen, n, c, f, fv)), (H, W), 0.01)
    with pytest.raises(ValueError, match="chunks of 16"):  # lists counting chunks of 8 faces
        trt.visibility(coefs, torch.cat([ids, ids], -1), n_act, (H, W))


@pytest.mark.parametrize("run", ["coarse120", "coarse_dr", "coarse_grid", "refiner_dr", "refiner_long"])
def test_committed_run_configs_load(run):
    """The committed runs' configs (written by the JAX package) load as
    model configs, through both readers, with the 16-face chunk."""
    path = ROOT / "runs" / run / "config.json"
    cfg, _ = config_from_run_json(path)
    trained = PosePredictorConfig(**load_config(path).model_config_kwargs())
    assert cfg.tile_face_chunk == trained.tile_face_chunk == trt.FACE_CHUNK
