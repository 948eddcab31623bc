"""Tile-binned triangle rasterizer: phase A and C in torch, phase B as a
hand-written CUDA kernel with a plain torch twin.

Counterpart of `megapose6d_tpu/ops/rasterizer_tiled.py`:
  Phase A (`prepare`): per image, the packed per-face plane table
    `[F, 32]` (3 edge planes, the 1/z plane and 6 attribute/z planes) and,
    per screen tile, the active face chunks sorted front to back by their
    nearest vertex depth, with their count `n_active`.
  Phase B (`visibility`): per pixel, the nearest face and its
    interpolated attributes. On a CUDA tensor it launches
    `csrc/visibility.cu` (the port of the Pallas `_visibility_kernel`); on
    a CPU tensor it runs `visibility_plain`, the same arithmetic in torch.
  Phase C (`shade`): perspective divide, the texture lookup of textured
    meshes (their uv rides through phases A and B in the colour slots, so
    the kernel is the same for both), lighting and eye-space normals.

The TPU kernel's hypothesis packing and 8192-face segments exist for TPU
VMEM; here a tile is one CUDA block of 16x32 pixels (`TILE_H`, `TILE_W`,
fixed in `csrc/visibility.cu` too), or a cluster of up to `MAX_SPLIT`
blocks that split its chain of chunks when a launch has few tiles (small
batches), chunks hold `FACE_CHUNK` faces (a constant of phase A, the plain
twin and the kernel alike), and any face count renders in one launch. Plane
constants are still rebased to the origin of the TPU kernel's 32x128 tile
that holds the pixel (`REBASE_HW`), so every pixel sees the TPU kernel's
arithmetic. The outputs do not depend on the batch or the face count.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .rasterizer import RenderOutput, apply_uv_as_colors, project_to_screen, sample_textures_bilinear

Tensor = torch.Tensor

TILE_H = 16  # one CUDA block per tile
TILE_W = 32
FACE_CHUNK = 16  # faces per chunk, a constant of the CUDA kernel
WARP_ROWS = 4  # each of the kernel's warps owns 4 rows x 32 columns of a tile
MAX_SPLIT = 16  # blocks (a thread block cluster) that may share a tile's chain
# (most tiles, blocks per tile) of a launch, in order; more tiles take one
# block a tile. From sweeps of the split at the main path's launch shapes on
# an H100 (PERF.md §6).
SPLIT_BY_TILES = ((150, 16), (600, 8), (6000, 3))
REBASE_HW = (32, 128)  # the TPU kernel's tile; a tile lies in one such cell
# The TPU kernel's scheduling knobs, which `render_meshes_tiled` takes and
# does not read: its tile height and the faces one program holds.
JAX_TILE_H = 32
MAX_FACES_PER_PROGRAM = 8192
N_ATTR = 6  # r, g, b, nx, ny, nz
COEF_W = 32  # 9 edge + 3 invz + 18 attr + 2 pad


def _face_coefs(
    screen: Tensor,  # [B, V, 3] (u, v, z)
    normals: Tensor,  # [B, V, 3]
    colors: Tensor,  # [B, V, 3]
    faces: Tensor,  # [B, F, 3]
    face_valid: Tensor,  # [B, F]
    z_near: float,
    backface_cull: bool = False,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Packed planes `[B, F, 32]`, bbox `[B, F, 4]`, valid `[B, F]` and
    the faces' nearest vertex depth `[B, F]`.

    Layout: a0 b0 c0 a1 b1 c1 a2 b2 c2 | az bz cz | 6x attr (a b c) | pad.
    Edge functions are orientation-normalized (inside <=> all e_i >= 0);
    attribute planes interpolate attr/z."""
    bidx = torch.arange(screen.shape[0], device=screen.device)[:, None, None]
    faces = faces.long()
    tri = screen[bidx, faces]  # [B, F, 3, 3]
    u, v, z = tri[..., 0], tri[..., 1], tri[..., 2]

    t1 = (u[..., 1] - u[..., 0]) * (v[..., 2] - v[..., 0])
    t2 = (v[..., 1] - v[..., 0]) * (u[..., 2] - u[..., 0])
    area = t1 - t2
    s = torch.where(area >= 0, 1.0, -1.0)
    abs_area = area.abs()
    # Scale-aware degeneracy cull: FMA noise on the cross product reaches
    # ~1e-4 px^2 at 100 px coordinates.
    area_ok = abs_area > 1e-5 * (t1.abs() + t2.abs() + 1e-9)
    zmin = z.amin(dim=-1)
    valid = face_valid & area_ok & (zmin > z_near)
    if backface_cull:
        # Outward-CCW winding projects camera-facing faces to negative
        # screen area (screen y points down).
        valid = valid & (area < 0)

    def edge(i, j):
        a = -(v[..., j] - v[..., i])
        b = u[..., j] - u[..., i]
        c = (v[..., j] - v[..., i]) * u[..., i] - (u[..., j] - u[..., i]) * v[..., i]
        return a * s, b * s, c * s

    e = [edge(1, 2), edge(2, 0), edge(0, 1)]
    inv_area = torch.where(area_ok, 1.0 / abs_area, torch.zeros_like(abs_area))
    iz = 1.0 / z.clamp_min(1e-6)  # [B, F, 3]

    def plane(g):
        return tuple(
            (e[0][k] * g[..., 0] + e[1][k] * g[..., 1] + e[2][k] * g[..., 2]) * inv_area
            for k in range(3)
        )

    cols = [c for abc in e for c in abc]
    cols += plane(iz)
    n_f = normals[bidx, faces]
    c_f = colors[bidx, faces]
    for k in range(3):
        cols += plane(c_f[..., k] * iz)
    for k in range(3):
        cols += plane(n_f[..., k] * iz)
    cols += [torch.zeros_like(area), torch.zeros_like(area)]
    packed = torch.stack(cols, dim=-1)  # [B, F, 32]

    bbox = torch.stack([u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)], dim=-1)
    return packed, bbox, valid, zmin


def prepare(
    screen: Tensor,
    normals: Tensor,
    colors: Tensor,
    faces: Tensor,
    face_valid: Tensor,
    resolution: tuple[int, int],
    z_near: float,
    backface_cull: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """Phase A -> (coefs `[B, F, 32]` f32, chunk ids `[B, T, n_chunks]` i32
    sorted front to back with the active ones first, n_active `[B, T]`
    i32). Tiles are row-major, `T = ceil(H/16) * ceil(W/32)`."""
    H, W = resolution
    n_th = -(-H // TILE_H)
    n_tw = -(-W // TILE_W)
    B, F = faces.shape[:2]
    if F % FACE_CHUNK:
        raise ValueError(f"face count {F} is not a multiple of the chunk, {FACE_CHUNK}")
    n_chunks = F // FACE_CHUNK
    dev = screen.device

    packed, bbox, valid, zmin = _face_coefs(
        screen, normals, colors, faces, face_valid, z_near, backface_cull
    )
    # Invalid faces can never pass the inside test (c0 = -1e30; filled on the
    # device, no host data, so CUDA graphs can capture it).
    neutral = torch.where(torch.arange(COEF_W, device=dev) == 2, -1e30, 0.0).to(packed.dtype)
    packed = torch.where(valid[..., None], packed, neutral)

    ty0 = (torch.arange(n_th, device=dev) * TILE_H)[None, :, None]
    tx0 = (torch.arange(n_tw, device=dev) * TILE_W)[None, :, None]
    over_y = (bbox[:, None, :, 1] < ty0 + TILE_H) & (bbox[:, None, :, 3] >= ty0)
    over_x = (bbox[:, None, :, 0] < tx0 + TILE_W) & (bbox[:, None, :, 2] >= tx0)
    overlap = over_y[:, :, None] & over_x[:, None] & valid[:, None, None]  # [B, th, tw, F]
    chunk_mask = overlap.reshape(B, n_th * n_tw, n_chunks, FACE_CHUNK).any(-1)

    # Active chunks nearest first, so the z-buffer fills early and later
    # chunks rarely win; inactive chunks sort to the back.
    zmin_face = torch.where(valid, zmin, torch.full_like(zmin, float("inf")))
    chunk_z = zmin_face.reshape(B, n_chunks, FACE_CHUNK).amin(-1)  # [B, n_chunks]
    key = torch.where(chunk_mask, chunk_z[:, None, :], torch.full_like(chunk_z[:, None, :], float("inf")))
    ids = torch.argsort(key, dim=-1, stable=True)
    n_active = chunk_mask.sum(dim=-1)
    return packed.contiguous(), ids.to(torch.int32).contiguous(), n_active.to(torch.int32).contiguous()


def _tiles_to_image(x: Tensor, n_th: int, n_tw: int, H: int, W: int) -> Tensor:
    """`[B, T, TILE_H*TILE_W, ...]` -> `[B, H, W, ...]`."""
    B, rest = x.shape[0], x.shape[3:]
    img = x.reshape((B, n_th, n_tw, TILE_H, TILE_W) + rest).transpose(2, 3)
    return img.reshape((B, n_th * TILE_H, n_tw * TILE_W) + rest)[:, :H, :W]


def visibility_plain(
    coefs: Tensor,
    chunk_ids: Tensor,
    n_active: Tensor,
    resolution: tuple[int, int],
    split: int = 1,
) -> tuple[Tensor, Tensor, Tensor]:
    """Phase B in plain torch, the same arithmetic as the CUDA kernel.

    Each tile's chain of `n` active chunks is walked in parts, as the
    kernel's split launch walks it: a chain of `split` chunks or more is cut
    into `split`, part `s` taking the chunks `[s*n // split,
    (s+1)*n // split)`, a shorter one is one part. A part keeps per pixel
    the best 1/z and its face id (a chunk's nearest covering face, ties to
    the largest id, a NaN voiding the chunk, replaces only a strictly
    smaller 1/z). The parts fold in order by the same strict rule, which is
    the walk through the whole chain, and the winner's 6 attribute planes
    are evaluated once. So every `split` gives the same bits.

    Returns invz `[B, H, W]` f32 (-inf background), face id `[B, H, W]`
    i32 (-1 background) and attributes/z `[B, H, W, 6]` f32. Images go
    through in slices that keep each temporary near 2**27 floats."""
    B, F, _ = coefs.shape
    T, n_chunks = chunk_ids.shape[1:]
    if n_chunks * FACE_CHUNK != F:
        raise ValueError(f"chunk lists of {n_chunks} chunks do not cover {F} faces in chunks of {FACE_CHUNK}")
    P = TILE_H * TILE_W
    step = max(1, 2**27 // (T * FACE_CHUNK * 4 * P))
    if B > step:
        parts = [
            visibility_plain(coefs[s : s + step], chunk_ids[s : s + step], n_active[s : s + step],
                             resolution, split)
            for s in range(0, B, step)
        ]
        return tuple(torch.cat(p) for p in zip(*parts))
    H, W = resolution
    n_th, n_tw = -(-H // TILE_H), -(-W // TILE_W)
    dev = coefs.device
    t = torch.arange(T, device=dev)
    tile_row0, tile_col0 = (t // n_tw) * TILE_H, (t % n_tw) * TILE_W
    row0 = tile_row0 // REBASE_HW[0] * REBASE_HW[0]  # rebase origin [T]
    col0 = tile_col0 // REBASE_HW[1] * REBASE_HW[1]
    pix = torch.arange(P, device=dev)
    pu = ((tile_col0 - col0)[:, None] + pix % TILE_W).float()  # [T, P] local coords
    pv = ((tile_row0 - row0)[:, None] + pix // TILE_W).float()
    row0, col0 = row0.float(), col0.float()  # [T]

    best = torch.full((B, T, P), float("-inf"), device=dev)
    fid = torch.full((B, T, P), -1, dtype=torch.int32, device=dev)
    coefs_c = coefs.reshape(B, F // FACE_CHUNK, FACE_CHUNK, COEF_W)
    j_ids = torch.arange(FACE_CHUNK, device=dev)[None, :, None]
    n_act = n_active.long()
    n_parts = torch.where(n_act >= split, split, 1)  # [B, T]
    for part in range(split):
        lo, hi = part * n_act // n_parts, (part + 1) * n_act // n_parts  # [B, T]
        hi = torch.where(part < n_parts, hi, lo)
        p_best, p_fid = torch.full_like(best, float("-inf")), torch.full_like(fid, -1)
        n_max = int((hi - lo).max()) if n_act.numel() else 0
        for i in range(n_max):
            # Only the (image, tile) pairs whose part has an i-th chunk: M of them.
            bi, ti = torch.nonzero(i < hi - lo, as_tuple=True)
            ci = chunk_ids[bi, ti, lo[bi, ti] + i].long()  # [M]
            cf = coefs_c[bi, ci]  # [M, chunk, 32]
            c0, r0 = col0[ti, None, None, None], row0[ti, None, None, None]
            # Edge and 1/z planes of every face at every pixel: [M, chunk, 4, P].
            a, b, c = cf[..., 0:12:3, None], cf[..., 1:12:3, None], cf[..., 2:12:3, None]
            c = c + a * c0 + b * r0
            val = a * pu[ti, None, None] + b * pv[ti, None, None] + c
            inside = (val[:, :, 0] >= 0) & (val[:, :, 1] >= 0) & (val[:, :, 2] >= 0)
            cand = torch.where(inside, val[:, :, 3], float("-inf"))  # [M, chunk, P]
            c_best = cand.amax(dim=1)  # NaN propagates and voids the chunk
            c_j = torch.where(cand >= c_best[:, None], j_ids, -1).amax(dim=1)  # [M, P]
            better = c_best > p_best[bi, ti]
            p_best[bi, ti] = torch.where(better, c_best, p_best[bi, ti])
            p_fid[bi, ti] = torch.where(better, (ci[:, None] * FACE_CHUNK + c_j).int(), p_fid[bi, ti])
        better = p_best > best  # strict: an earlier part keeps a tie
        best, fid = torch.where(better, p_best, best), torch.where(better, p_fid, fid)

    # The winner's 6 attribute planes at each pixel: [B, T, P, 6].
    row = coefs[torch.arange(B, device=dev)[:, None, None], fid.clamp_min(0).long(), 12:30]
    a, b, c = row[..., 0::3], row[..., 1::3], row[..., 2::3]
    c = c + a * col0[:, None, None] + b * row0[:, None, None]
    attr = a * pu[..., None] + b * pv[..., None] + c
    attr = torch.where((fid >= 0)[..., None], attr, 0.0)
    return (
        _tiles_to_image(best[:, :, :, None], n_th, n_tw, H, W)[..., 0],
        _tiles_to_image(fid[:, :, :, None], n_th, n_tw, H, W)[..., 0],
        _tiles_to_image(attr, n_th, n_tw, H, W),
    )


def cull_plain(
    coefs: Tensor,
    chunk_ids: Tensor,
    n_active: Tensor,
    resolution: tuple[int, int],
) -> Tensor:
    """The CUDA kernel's per-warp face cull (`cull_mask` in
    `csrc/visibility.cu`), the same arithmetic in torch.

    Returns `[B, T, n, FACE_CHUNK, TILE_H // WARP_ROWS]` bool, with `n`
    the largest `n_active`: True where warp `w` of tile `t` evaluates face
    `j` of the tile's `i`-th chunk, False where the kernel skips it
    (and past `n_active`). A face is skipped when one of its edge planes,
    rebased and evaluated as phase B evaluates it, is below 0 at the 4
    corner pixel centres of the warp's 4x32 pixels. Rounding is monotone,
    so the computed plane is largest at one of those corners, and such a
    face fails the inside test at every pixel of the warp."""
    B, F, _ = coefs.shape
    T = chunk_ids.shape[1]
    n_tw = -(-resolution[1] // TILE_W)
    n = int(n_active.max()) if n_active.numel() else 0
    dev = coefs.device
    t = torch.arange(T, device=dev)
    tile_row0, tile_col0 = (t // n_tw) * TILE_H, (t % n_tw) * TILE_W
    row0 = tile_row0 // REBASE_HW[0] * REBASE_HW[0]  # rebase origin [T]
    col0 = tile_col0 // REBASE_HW[1] * REBASE_HW[1]
    # Footprint corners in local coordinates, shaped [1, T, 1, 1, warp, 1].
    fp = lambda x: x.float()[None, :, None, None, :, None]
    warps = torch.arange(TILE_H // WARP_ROWS, device=dev) * WARP_ROWS
    u_lo = fp((tile_col0 - col0)[:, None].expand(-1, len(warps)))
    u_hi = u_lo + (TILE_W - 1)
    v_lo = fp((tile_row0 - row0)[:, None] + warps)
    v_hi = v_lo + (WARP_ROWS - 1)
    cf = coefs.reshape(B, F // FACE_CHUNK, FACE_CHUNK, COEF_W)
    cf = cf[torch.arange(B, device=dev)[:, None, None], chunk_ids[:, :, :n].long()]  # [B, T, n, 16, 32]
    a, b, c = cf[..., 0:9:3], cf[..., 1:9:3], cf[..., 2:9:3]  # the edge planes
    c = c + a * col0.float()[None, :, None, None, None] + b * row0.float()[None, :, None, None, None]
    a, b, c = (x[..., None, :] for x in (a, b, c))  # [B, T, n, 16, 1, 3]
    below = True
    for u in (u_lo, u_hi):
        for v in (v_lo, v_hi):
            below = below & (a * u + b * v + c < 0)
    active = torch.arange(n, device=dev) < n_active[..., None]  # [B, T, n]
    return ~below.any(-1) & active[..., None, None]


def split_for(n_tiles: int, n_chunks: int) -> int:
    """Blocks per tile (a cluster) of a launch over `n_tiles` (image, tile)
    pairs of `n_chunks` chunks each, by `SPLIT_BY_TILES`, at most
    `n_chunks`. From the shapes alone, so that no launch waits for the
    device (a CUDA graph captures it as it is). The kernel splits only the
    chains of at least that many active chunks; one block walks the others."""
    for most, split in SPLIT_BY_TILES:
        if n_tiles <= most:
            return max(1, min(split, n_chunks))
    return 1


class _VisibilityKernel:
    """ctypes binding of `csrc/visibility.cu`, built at first use.

    `launches` counts the kernel launches made through `__call__`."""

    source = "visibility.cu"

    def __init__(self):
        self.launches = 0
        self.build_report = ""
        self._lib = None
        self._launch = None
        self._lock = threading.Lock()

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                from ._nvcc import build_library

                lib, self.build_report = build_library(self.source)
                fn = lib.visibility_launch
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self._lib, self._launch = lib, fn
        return self._lib

    def __call__(self, coefs, chunk_ids, n_active, resolution, split=None):
        """Launch on the current stream of `coefs`' device; `split` blocks
        per tile (default `split_for` of the shapes). No host sync."""
        H, W = resolution
        B, F, cw = coefs.shape
        T, n_chunks = chunk_ids.shape[1:]
        dev = coefs.device
        if not (coefs.is_cuda and chunk_ids.device == dev and n_active.device == dev):
            raise ValueError("inputs must be tensors on one CUDA device")
        if (cw != COEF_W or coefs.dtype != torch.float32 or chunk_ids.dtype != torch.int32
                or n_active.dtype != torch.int32):
            raise ValueError(f"coefs must be [B, F, {COEF_W}] float32, chunk_ids and n_active int32")
        if chunk_ids.shape[0] != B or n_active.shape != (B, T):
            raise ValueError("chunk_ids/n_active do not match coefs")
        if T != -(-H // TILE_H) * -(-W // TILE_W) or n_chunks * FACE_CHUNK != F:
            raise ValueError(f"tile or chunk layout does not match the inputs (chunks of {FACE_CHUNK} faces)")
        if not (coefs.is_contiguous() and chunk_ids.is_contiguous() and n_active.is_contiguous()):
            raise ValueError("inputs must be contiguous")
        split = split_for(B * T, n_chunks) if split is None else split
        if not 1 <= split <= MAX_SPLIT:
            raise ValueError(f"split {split} is not in [1, {MAX_SPLIT}]")
        if self._launch is None:
            self.library()
        invz = coefs.new_empty((B, H, W))
        fid = chunk_ids.new_empty((B, H, W))
        attr = coefs.new_empty((B, H, W, N_ATTR))
        err = self._launch(
            coefs.data_ptr(), chunk_ids.data_ptr(), n_active.data_ptr(),
            invz.data_ptr(), fid.data_ptr(), attr.data_ptr(),
            B, F, T, n_chunks, H, W, split, dev.index, torch._C._cuda_getCurrentRawStream(dev.index),
        )
        if err != 0:
            raise RuntimeError(f"visibility kernel launch failed: CUDA error {err}")
        self.launches += 1
        return invz, fid, attr


visibility_kernel = _VisibilityKernel()


def visibility(
    coefs: Tensor,
    chunk_ids: Tensor,
    n_active: Tensor,
    resolution: tuple[int, int],
) -> tuple[Tensor, Tensor, Tensor]:
    """Phase B: the CUDA kernel for CUDA tensors, `visibility_plain` for
    CPU tensors. Never falls back from one to the other."""
    if coefs.is_cuda:
        return visibility_kernel(coefs, chunk_ids, n_active, resolution)
    return visibility_plain(coefs, chunk_ids, n_active, resolution)


def prepare_render(
    vertices: Tensor,
    normals: Tensor,
    colors: Tensor,
    faces: Tensor,
    face_valid: Tensor,
    TCO: Tensor,
    K: Tensor,
    resolution: tuple[int, int],
    z_near: float = 0.01,
    backface_cull: bool = False,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Everything before phase B: non-finite poses replaced by the
    identity (their faces invalid), projection, face padding to a multiple
    of `FACE_CHUNK`, phase A. Returns (TCO, coefs, chunk_ids, n_active)."""
    F = faces.shape[1]
    eye = torch.eye(4, dtype=TCO.dtype, device=TCO.device)
    finite = torch.isfinite(TCO).all(dim=-1).all(dim=-1)
    TCO = torch.where(finite[:, None, None], TCO, eye)
    screen = project_to_screen(vertices, TCO, K)
    face_valid = face_valid & finite[:, None]
    if F % FACE_CHUNK:
        pad = FACE_CHUNK - F % FACE_CHUNK
        faces = torch.nn.functional.pad(faces, (0, 0, 0, pad))
        face_valid = torch.nn.functional.pad(face_valid, (0, pad))
    return (TCO,) + prepare(
        screen, normals, colors, faces, face_valid, resolution, z_near, backface_cull=backface_cull,
    )


def shade(
    invz: Tensor,
    fid: Tensor,
    attrs: Tensor,
    TCO: Tensor,
    light_ambient: float | Tensor = 0.1,
    light_point: float | Tensor = 0.4,
    textures: Tensor | None = None,
    has_tex: Tensor | None = None,
) -> RenderOutput:
    """Phase C: perspective divide, the albedo (the texture at the
    interpolated uv where `has_tex [B]`, given `textures [B, TS, TS, 3]`;
    else the interpolated colour), lighting `ambient + point * |n_obj|_1`
    (six axis lights in the object frame), eye-space normals."""
    B = invz.shape[0]
    hit = fid >= 0
    invz_safe = invz.clamp_min(1e-6)
    depth = torch.where(hit, 1.0 / invz_safe, torch.zeros_like(invz_safe))
    attrs = attrs / invz_safe[..., None]  # perspective divide
    albedo = attrs[..., 0:3].clamp(0.0, 1.0)
    if textures is not None and has_tex is not None:
        tex_rgb = sample_textures_bilinear(textures, attrs[..., 0:2].clamp(0.0, 1.0))
        albedo = torch.where(has_tex[:, None, None, None], tex_rgb, albedo)
    n_obj = attrs[..., 3:6]
    n_obj = n_obj / torch.linalg.norm(n_obj, dim=-1, keepdim=True).clamp_min(1e-9)
    # Python numbers are filled on the device (no host copy: CUDA-graph safe).
    light = lambda x: (x.to(invz.device, torch.float32).expand(B) if torch.is_tensor(x)
                       else torch.full((B,), float(x), device=invz.device))
    amb = light(light_ambient)[:, None, None, None]
    pnt = light(light_point)[:, None, None, None]
    intensity = amb + pnt * n_obj.abs().sum(-1, keepdim=True)
    rgb = torch.where(hit[..., None], (albedo * intensity).clamp(0, 1), 0.0)
    n_eye = torch.einsum("bij,bhwj->bhwi", TCO[:, :3, :3], n_obj)
    normals_img = torch.where(hit[..., None], (n_eye + 1.0) * 0.5, 0.0)
    return RenderOutput(rgb=rgb, normals=normals_img, depth=depth, mask=hit)


def render_meshes_tiled(
    vertices: Tensor,
    normals: Tensor,
    colors: Tensor,
    faces: Tensor,
    face_valid: Tensor,
    TCO: Tensor,
    K: Tensor,
    resolution: tuple[int, int],
    z_near: float = 0.01,
    chunk: int = 16,
    light_ambient: float | Tensor = 0.1,
    light_point: float | Tensor = 0.4,
    backface_cull: bool = False,
    tile_h: int = JAX_TILE_H,
    hyp_pack: int = 1,
    uvs: Tensor | None = None,
    textures: Tensor | None = None,
    has_tex: Tensor | None = None,
    max_faces_per_program: int = MAX_FACES_PER_PROGRAM,
) -> RenderOutput:
    """Render `B` meshes (`vertices/normals/colors [B, V, 3]`, `faces
    [B, F, 3]`, `face_valid [B, F]`) at poses `TCO [B, 4, 4]` with
    intrinsics `K [B, 3, 3]` to `resolution` (H, W).

    `backface_cull=True` needs outward-CCW winding and closed surfaces
    (meshes from `MeshDataBase`). Poses with non-finite entries render
    empty. Textured meshes pass `uvs [B, V, 2]`, `textures [B, TS, TS, 3]`
    uint8 and `has_tex [B]`.

    `chunk`, `tile_h`, `hyp_pack` and `max_faces_per_program` are the TPU
    kernel's scheduling knobs (faces per chunk, tile height, hypotheses a
    program, faces a program before the face axis is rendered in segments
    merged by depth). They change no pixel there (the JAX package's
    `tests/test_rasterizer_tiled.py::test_chunk_sizes_equivalent` and
    `::test_face_segmentation_equivalence`), so any positive values are
    taken here and not read: the CUDA kernel keeps its own layout (16 x 32
    tiles, chunks of `FACE_CHUNK` faces, the whole face table in global
    memory, planes rebased to the 32 x 128 cell)."""
    for name, value in (("chunk", chunk), ("tile_h", tile_h), ("hyp_pack", hyp_pack),
                        ("max_faces_per_program", max_faces_per_program)):
        if int(value) < 1:
            raise ValueError(f"{name} must be positive, not {value}")
    if uvs is None or textures is None or has_tex is None:
        uvs = textures = has_tex = None  # textured only with all three
    colors = apply_uv_as_colors(colors, uvs, has_tex)
    TCO, coefs, chunk_ids, n_active = prepare_render(
        vertices, normals, colors, faces, face_valid, TCO, K, resolution, z_near, backface_cull,
    )
    invz, fid, attrs = visibility(coefs, chunk_ids, n_active, resolution)
    return shade(invz, fid, attrs, TCO, light_ambient, light_point, textures, has_tex)
