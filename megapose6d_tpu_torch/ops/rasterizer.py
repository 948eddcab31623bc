"""Render outputs and screen projection shared by the renderers, and the
scan renderer.

Counterpart of `megapose6d_tpu/ops/rasterizer.py`. The scan renderer
(`render_meshes`) is the JAX package's XLA baseline, plain torch here (it
was no Pallas kernel there): two-pass z-buffered barycentric
rasterization.
  Pass 1 (visibility): over static face chunks, the edge functions of
    every face of the chunk at every pixel; per pixel the nearest (max
    1/z) face id. Two-sided (no backface cull), the scale-aware degeneracy
    cull `|area| > 1e-5 (|t1| + |t2| + 1e-9)`, faces whose nearest vertex
    lies behind `z_near` culled. Within a chunk the first index wins a tie;
    across chunks a face must be strictly nearer, so the first face wins
    overall. A NaN voids its pixel's chunk, as `jnp.max` does there.
  Pass 2 (shading): per pixel the winning face's vertices, barycentrics
    recomputed, depth, colour and normal interpolated perspective-correct;
    textured meshes sample their texture at the interpolated uv.
Images go through in groups that keep each `[group, chunk, H*W]`
temporary of pass 1 at most `MAX_GROUP_ELEMS` floats; the output does not
depend on the grouping.
Conventions: OpenCV intrinsics, pixel (i, j) center at (u=j, v=i), depth in
meters with 0 = background, outputs NHWC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class RenderOutput(NamedTuple):
    rgb: Tensor  # [B, H, W, 3] in [0, 1]
    normals: Tensor  # [B, H, W, 3] in [0, 1] (eye-space, (n+1)/2)
    depth: Tensor  # [B, H, W] meters, 0 = background
    mask: Tensor  # [B, H, W] bool


def project_to_screen(vertices: Tensor, TCO: Tensor, K: Tensor, z_min: float = 1e-3) -> Tensor:
    """Object-frame vertices `[B, V, 3]` -> screen (u, v, z_cam) `[B, V, 3]`."""
    v_cam = torch.einsum("...ij,...nj->...ni", TCO[..., :3, :3], vertices) + TCO[..., None, :3, 3]
    z = v_cam[..., 2]
    z_safe = z.clamp_min(z_min)
    u = K[..., 0, 0, None] * v_cam[..., 0] / z_safe + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * v_cam[..., 1] / z_safe + K[..., 1, 2, None]
    return torch.stack([u, v, z], dim=-1)


def sample_textures_bilinear(textures: Tensor, uv: Tensor) -> Tensor:
    """Per-image bilinear texture lookup. `textures [B, TS, TS, 3]` uint8,
    `uv [B, H, W, 2]` in [0, 1] (u right, v down) -> `[B, H, W, 3]` float
    in [0, 1]. Each image samples one object's texture."""
    B, TS = textures.shape[0], textures.shape[1]
    H, W = uv.shape[1], uv.shape[2]
    x = (uv[..., 0] * TS - 0.5).clamp(0.0, TS - 1.0)
    y = (uv[..., 1] * TS - 0.5).clamp(0.0, TS - 1.0)
    x0, y0 = x.floor().long(), y.floor().long()
    x1, y1 = (x0 + 1).clamp_max(TS - 1), (y0 + 1).clamp_max(TS - 1)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    flat = textures.reshape(B, TS * TS, 3).float() / 255.0

    def texel(yy, xx):
        idx = (yy * TS + xx).reshape(B, H * W, 1).expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(B, H, W, 3)

    top = texel(y0, x0) * (1 - fx) + texel(y0, x1) * fx
    bot = texel(y1, x0) * (1 - fx) + texel(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def apply_uv_as_colors(colors: Tensor, uvs: Tensor | None, has_tex: Tensor | None) -> Tensor:
    """For textured meshes, (u, v, 0) in the colour attribute slots
    `[B, V, 3]`: each image renders one object, so the slots can switch
    meaning per image at no cost to the rasterizer."""
    if uvs is None or has_tex is None:
        return colors
    uv3 = torch.cat([uvs, torch.zeros_like(uvs[..., :1])], dim=-1)
    return torch.where(has_tex[:, None, None], uv3, colors)


# Pass 1 holds a few temporaries of `[group, chunk, H*W]`; each is kept at
# or below this many elements (2**27 float32 = 512 MiB).
MAX_GROUP_ELEMS = 2**27


def _pixel_grid(resolution: tuple[int, int], device) -> tuple[Tensor, Tensor]:
    """Pixel centres (u, v) `[H*W]`, row-major."""
    H, W = resolution
    return (torch.arange(W, dtype=torch.float32, device=device).repeat(H),
            torch.arange(H, dtype=torch.float32, device=device).repeat_interleave(W))


def _visibility(
    screen: Tensor,  # [B, V, 3] (u, v, z)
    faces: Tensor,  # [B, F, 3]
    face_valid: Tensor,  # [B, F]
    resolution: tuple[int, int],
    chunk: int,
    z_near: float,
) -> Tensor:
    """Pass 1 -> face id `[B, H*W]` int64, -1 = background.

    An edge function `(bx - ax) (v - ay) - (by - ay) (u - ax)` takes its
    two products on the pixel rows and columns (`[B, C, H]`, `[B, C, W]`)
    and only the difference per pixel, the same float32 operations on the
    same values as per pixel throughout."""
    B, F = faces.shape[:2]
    H, W = resolution
    n_chunks = -(-F // chunk)
    pad = n_chunks * chunk - F
    faces = torch.nn.functional.pad(faces.long(), (0, 0, 0, pad))
    face_valid = torch.nn.functional.pad(face_valid, (0, pad))
    dev = screen.device
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    bidx = torch.arange(B, device=dev)[:, None, None]
    best = torch.full((B, H * W), float("-inf"), device=dev)
    best_face = torch.full((B, H * W), -1, dtype=torch.long, device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        tri = screen[bidx, faces[:, sl]]  # [B, C, 3, 3]
        u0, v0, z0 = tri[..., 0, 0, None], tri[..., 0, 1, None], tri[..., 0, 2, None]  # [B, C, 1]
        u1, v1, z1 = tri[..., 1, 0, None], tri[..., 1, 1, None], tri[..., 1, 2, None]
        u2, v2, z2 = tri[..., 2, 0, None], tri[..., 2, 1, None], tri[..., 2, 2, None]

        def edge(ax, ay, bx, by):  # cross(b - a, p - a) at every pixel: [B, C, H*W]
            p_rows = (bx - ax) * (rows - ay)  # [B, C, H]
            p_cols = (by - ay) * (cols - ax)  # [B, C, W]
            return (p_rows[..., :, None] - p_cols[..., None, :]).reshape(B, -1, H * W)

        e0, e1, e2 = edge(u1, v1, u2, v2), edge(u2, v2, u0, v0), edge(u0, v0, u1, v1)
        t1 = (u1 - u0) * (v2 - v0)
        t2 = (v1 - v0) * (u2 - u0)
        area = t1 - t2  # [B, C, 1]
        # Scale-aware degeneracy cull: FMA noise on the cross product reaches
        # ~1e-4 px^2 for zero-area faces at 100 px coordinates.
        area_ok = area.abs() > 1e-5 * (t1.abs() + t2.abs() + 1e-9)
        # Inside: every edge >= 0 (area >= 0) or every edge <= 0; a NaN edge
        # makes the min and max NaN, so it is never inside.
        inside = torch.where(area >= 0, torch.minimum(torch.minimum(e0, e1), e2) >= 0,
                             torch.maximum(torch.maximum(e0, e1), e2) <= 0)
        del e2
        inv_area = torch.where(area_ok, 1.0 / area, torch.zeros_like(area))
        l0 = e0.mul_(inv_area)
        l1 = e1.mul_(inv_area)
        l2 = torch.sub(1.0, l0).sub_(l1)
        invz = l0.div_(z0).add_(l1.div_(z1)).add_(l2.div_(z2))  # [B, C, H*W], in e0's storage
        del e1, l1, l2
        inside &= area_ok & face_valid[:, sl, None] & (torch.minimum(torch.minimum(z0, z1), z2) > z_near)
        invz = torch.where(inside, invz, float("-inf"))
        del inside
        # The nearest face, the first of a tie (NaN propagates and voids the
        # chunk at that pixel: NaN > best is false).
        c_best, c_arg = invz.max(dim=1)
        better = c_best > best
        best = torch.where(better, c_best, best)
        best_face = torch.where(better, c_arg + c * chunk, best_face)
    return best_face


def _shade(
    screen: Tensor,  # [B, V, 3]
    normals: Tensor,  # [B, V, 3] object frame
    colors: Tensor,  # [B, V, 3]
    faces: Tensor,  # [B, F, 3]
    R_co: Tensor,  # [B, 3, 3] rotation camera <- object
    face_id: Tensor,  # [B, HW]
    resolution: tuple[int, int],
    light_ambient: Tensor,  # [B]
    light_point: Tensor,  # [B]
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Pass 2 -> (albedo `[B, HW, 3]` (0 off the mesh), intensity `[B, HW]`,
    eye-space normals mapped to [0, 1] `[B, HW, 3]`, depth `[B, HW]`, hit
    `[B, HW]`). Lighting is `ambient + point * |n_obj|_1`: six axis lights
    in the object frame."""
    B = screen.shape[0]
    hit = face_id >= 0
    bidx = torch.arange(B, device=screen.device)[:, None]
    vidx = faces.long()[bidx, face_id.clamp_min(0)]  # [B, HW, 3]
    bv = bidx[..., None]
    tri = screen[bv, vidx]  # [B, HW, 3, 3]
    u, v, z = tri[..., 0], tri[..., 1], tri[..., 2]
    px_u, px_v = _pixel_grid(resolution, screen.device)
    # Screen-space barycentrics at the pixel centres.
    e0 = (u[..., 2] - u[..., 1]) * (px_v - v[..., 1]) - (v[..., 2] - v[..., 1]) * (px_u - u[..., 1])
    e1 = (u[..., 0] - u[..., 2]) * (px_v - v[..., 2]) - (v[..., 0] - v[..., 2]) * (px_u - u[..., 2])
    area = (u[..., 1] - u[..., 0]) * (v[..., 2] - v[..., 0]) - (v[..., 1] - v[..., 0]) * (u[..., 2] - u[..., 0])
    inv_area = torch.where(area.abs() > 1e-9, 1.0 / area, torch.zeros_like(area))
    l0 = e0 * inv_area
    l1 = e1 * inv_area
    lam = torch.stack([l0, l1, 1.0 - l0 - l1], -1)  # [B, HW, 3]
    invz_per_v = 1.0 / z.clamp_min(1e-6)
    invz = (lam * invz_per_v).sum(-1)
    depth = torch.where(hit, 1.0 / invz.clamp_min(1e-6), torch.zeros_like(invz))
    wgt = (lam * invz_per_v / invz.clamp_min(1e-6)[..., None])[..., None]  # perspective-correct [B, HW, 3, 1]
    n_obj = (normals[bv, vidx] * wgt).sum(-2)  # [B, HW, 3]
    n_obj = n_obj / torch.linalg.norm(n_obj, dim=-1, keepdim=True).clamp_min(1e-9)
    albedo = (colors[bv, vidx] * wgt).sum(-2)
    intensity = light_ambient[:, None] + light_point[:, None] * n_obj.abs().sum(-1)
    n_eye = torch.einsum("bij,bnj->bni", R_co, n_obj)
    normals_img = torch.where(hit[..., None], (n_eye + 1.0) * 0.5, 0.0)
    albedo = torch.where(hit[..., None], albedo, 0.0)
    return albedo, intensity, normals_img, depth, hit


def _light(x: float | Tensor, B: int, device) -> Tensor:
    """A scalar or `[B]` light as `[B]` float32 on `device` (a Python
    number filled on the device: no host copy, CUDA-graph safe)."""
    if torch.is_tensor(x):
        return x.to(device, torch.float32).expand(B)
    return torch.full((B,), float(x), device=device)


def render_meshes(
    vertices: Tensor,  # [B, V, 3] object frame
    normals: Tensor,  # [B, V, 3]
    colors: Tensor,  # [B, V, 3]
    faces: Tensor,  # [B, F, 3]
    face_valid: Tensor,  # [B, F] bool
    TCO: Tensor,  # [B, 4, 4]
    K: Tensor,  # [B, 3, 3]
    resolution: tuple[int, int],
    z_near: float = 0.01,
    chunk: int = 64,
    light_ambient: float | Tensor = 0.1,
    light_point: float | Tensor = 0.4,
    uvs: Tensor | None = None,
    textures: Tensor | None = None,
    has_tex: Tensor | None = None,
    group: int | None = None,
) -> RenderOutput:
    """The scan renderer: `B` (mesh, pose) hypotheses at `resolution`
    (H, W), `chunk` faces a step of pass 1.

    Textured meshes pass `uvs [B, V, 2]`, `textures [B, TS, TS, 3]` uint8
    and `has_tex [B]` (textured images then ignore `colors`). The lights
    are scalars or `[B]` tensors. Poses with non-finite entries render
    empty. `group` images go through pass 1 at a time (default: as many as
    `MAX_GROUP_ELEMS` allows); it changes no output."""
    B = TCO.shape[0]
    H, W = resolution
    finite = torch.isfinite(TCO).all(dim=-1).all(dim=-1)
    TCO = torch.where(finite[:, None, None], TCO, torch.eye(4, dtype=TCO.dtype, device=TCO.device))
    screen = project_to_screen(vertices, TCO, K)
    face_valid = face_valid & finite[:, None]
    amb, pnt = _light(light_ambient, B, screen.device), _light(light_point, B, screen.device)
    textured = uvs is not None and textures is not None and has_tex is not None
    colors = apply_uv_as_colors(colors, uvs, has_tex) if textured else colors
    if group is None:
        group = max(1, MAX_GROUP_ELEMS // (chunk * H * W))
    parts = []
    for s in range(0, B, group):
        g = slice(s, s + group)
        n = screen[g].shape[0]
        face_id = _visibility(screen[g], faces[g], face_valid[g], resolution, chunk, z_near)
        albedo, intensity, nrm, depth, mask = (x.reshape((n, H, W) + x.shape[2:]) for x in _shade(
            screen[g], normals[g], colors[g], faces[g], TCO[g, :3, :3], face_id, resolution, amb[g], pnt[g]))
        if textured:
            # Textured images carry their interpolated uv in the albedo slots.
            tex_rgb = sample_textures_bilinear(textures[g], albedo[..., 0:2].clamp(0.0, 1.0))
            albedo = torch.where(has_tex[g, None, None, None], tex_rgb, albedo)
        rgb = torch.where(mask[..., None], (albedo * intensity[..., None]).clamp(0.0, 1.0), 0.0)
        parts.append(RenderOutput(rgb=rgb, normals=nrm, depth=depth, mask=mask))
    return RenderOutput(*(torch.cat(p) for p in zip(*parts)))


def render_batched_meshes(meshes, TCO: Tensor, K: Tensor, resolution: tuple[int, int], **kw) -> RenderOutput:
    """`render_meshes` of a selected `BatchedMeshes` batch (untextured, as
    the JAX package's wrapper)."""
    return render_meshes(meshes.vertices, meshes.normals, meshes.colors, meshes.faces, meshes.face_valid,
                         TCO, K, resolution, **kw)
