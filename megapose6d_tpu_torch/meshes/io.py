"""Mesh loading and preprocessing (host-side numpy).

Counterpart of `megapose6d_tpu/meshes/io.py`: PLY and OBJ meshes with
vertex colours or a texture image (`comment TextureFile` of a BOP PLY, the
`map_Kd` of an OBJ's material) in any format `native.decode_image` reads
(PNG, JPEG, TIFF), converted to RGB as PIL's `convert("RGB")` converts it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .. import native
from ..utils.imaging import to_rgb8
from ..utils.png import write_png


@dataclasses.dataclass
class TriMesh:
    """A triangle mesh with per-vertex attributes (float32/int32)."""

    vertices: np.ndarray  # [V, 3]
    faces: np.ndarray  # [F, 3]
    vertex_normals: np.ndarray | None = None  # [V, 3]
    vertex_colors: np.ndarray | None = None  # [V, 3] in [0, 1]
    # Per-pixel texturing: per-vertex uv in image convention (u right,
    # v down) and the texture image; both None for untextured meshes.
    vertex_uvs: np.ndarray | None = None  # [V, 2] float32 in [0, 1]
    texture: np.ndarray | None = None  # [TH, TW, 3] uint8

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, np.float32)
        self.faces = np.ascontiguousarray(self.faces, np.int32)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_faces(self) -> int:
        return len(self.faces)

    def with_computed_normals(self) -> "TriMesh":
        if self.vertex_normals is not None:
            return self
        return dataclasses.replace(
            self, vertex_normals=compute_vertex_normals(self.vertices, self.faces)
        )

    def scaled(self, scale: float) -> "TriMesh":
        return dataclasses.replace(self, vertices=self.vertices * np.float32(scale))

    def diameter(self, n_sample: int = 1000, seed: int = 0) -> float:
        """Approximate max pairwise vertex distance, on a vertex subsample."""
        v = self.vertices
        if len(v) > n_sample:
            v = v[np.random.RandomState(seed).choice(len(v), n_sample, replace=False)]
        d2 = ((v[None] - v[:, None]) ** 2).sum(-1)
        return float(np.sqrt(d2.max()))


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    vn = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str | Path) -> TriMesh:
    """Parse an ascii or binary-little-endian PLY (the BOP model format)."""
    data = Path(path).read_bytes()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"bad PLY header: {path}")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements: list[tuple[str, int, list]] = []  # (name, count, props)
    texture_file = None
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "comment" and len(tok) >= 3 and tok[1] == "TextureFile":
            texture_file = tok[2]  # BOP: `comment TextureFile obj_000001.png`
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append(("scalar", tok[1], tok[2]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}: {path}")

    verts = normals = colors = uvs = faces = None
    if fmt == "ascii":
        rows = body.decode("ascii").split("\n")
        cursor = 0
        for name, count, props in elements:
            chunk = rows[cursor : cursor + count]
            cursor += count
            if name == "vertex":
                arr = np.array([r.split() for r in chunk], dtype=np.float64)
                verts, normals, colors, uvs = _extract_vertex_cols(arr, [p[2] for p in props])
            elif name == "face":
                faces = _parse_ascii_faces(chunk)
    else:
        offset = 0
        for name, count, props in elements:
            if all(p[0] == "scalar" for p in props):
                dt = np.dtype([(p[2], "<" + _PLY_DTYPES[p[1]]) for p in props])
                arr = np.frombuffer(body, dt, count, offset)
                offset += dt.itemsize * count
                if name == "vertex":
                    cols = [p[2] for p in props]
                    flat = np.stack([arr[c].astype(np.float64) for c in cols], -1)
                    verts, normals, colors, uvs = _extract_vertex_cols(flat, cols)
                continue
            # An element with a list property: parse row by row.
            polys = []
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        cnt_dt = np.dtype("<" + _PLY_DTYPES[p[1]])
                        idx_dt = np.dtype("<" + _PLY_DTYPES[p[2]])
                        n = int(np.frombuffer(body, cnt_dt, 1, offset)[0])
                        offset += cnt_dt.itemsize
                        vals = np.frombuffer(body, idx_dt, n, offset)
                        offset += idx_dt.itemsize * n
                        if p[3] in ("vertex_indices", "vertex_index"):
                            polys.append(vals.astype(np.int64))
                    else:
                        offset += np.dtype("<" + _PLY_DTYPES[p[1]]).itemsize
            if name == "face":
                faces = _triangulate(polys)

    if verts is None or faces is None:
        raise ValueError(f"PLY missing vertices or faces: {path}")
    texture = None
    if texture_file is not None and uvs is not None:
        tex_path = Path(path).parent / texture_file
        if tex_path.exists():
            texture = _read_rgb(tex_path)
            uvs = np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], axis=-1)  # GL v up -> image rows
    if texture is None:
        uvs = None
    return TriMesh(
        vertices=verts.astype(np.float32),
        faces=faces.astype(np.int32),
        vertex_normals=None if normals is None else normals.astype(np.float32),
        vertex_colors=None if colors is None else colors.astype(np.float32),
        vertex_uvs=None if uvs is None else uvs.astype(np.float32),
        texture=texture,
    )


def _read_rgb(path: Path) -> np.ndarray:
    """A texture image as `[H, W, 3]` uint8, as PIL's `convert("RGB")`."""
    return to_rgb8(native.decode_image(path.read_bytes()))


def _extract_vertex_cols(arr, cols):
    def get(names):
        idx = [cols.index(n) for n in names if n in cols]
        return arr[:, idx] if len(idx) == len(names) else None

    colors = get(["red", "green", "blue"])
    if colors is not None and colors.max() > 1.0:
        colors = colors / 255.0
    uvs = get(["texture_u", "texture_v"])
    if uvs is None:
        uvs = get(["s", "t"])
    return get(["x", "y", "z"]), get(["nx", "ny", "nz"]), colors, uvs


def _parse_ascii_faces(rows: list[str]) -> np.ndarray:
    polys = []
    for r in rows:
        tok = r.split()
        if tok:
            n = int(tok[0])
            polys.append(np.array(tok[1 : 1 + n], dtype=np.int64))
    return _triangulate(polys)


def _triangulate(polys: list[np.ndarray]) -> np.ndarray:
    tris = [(p[0], p[k], p[k + 1]) for p in polys for k in range(1, len(p) - 1)]
    return np.asarray(tris, np.int64)


def _wrap_unit(u: np.ndarray) -> np.ndarray:
    """Wrap texture coordinates into [0, 1], keeping values already in
    range (u = 1.0 stays 1.0, where `% 1.0` would give 0.0)."""
    u = np.asarray(u, np.float64)
    return np.where((u >= 0.0) & (u <= 1.0), u, u - np.floor(u))


def load_obj(path: str | Path, bake_texture: bool = True) -> TriMesh:
    """Parse a Wavefront OBJ. The first `map_Kd` of its `.mtl` is baked to
    vertex colours, or with `bake_texture=False` kept for per-pixel
    texturing: vertices are then split on unique (v, vt) pairs so that uvs
    are per vertex."""
    path = Path(path)
    vs, vts, faces_v, faces_vt = [], [], [], []
    mtl_file = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                vs.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                vts.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "mtllib":
                mtl_file = tok[1]
            elif tok[0] == "f":
                idxs, tidxs = [], []
                for vert in tok[1:]:
                    parts = vert.split("/")
                    idxs.append(int(parts[0]))
                    if len(parts) > 1 and parts[1]:
                        tidxs.append(int(parts[1]))
                for k in range(1, len(idxs) - 1):
                    faces_v.append((idxs[0], idxs[k], idxs[k + 1]))
                    if len(tidxs) == len(idxs):
                        faces_vt.append((tidxs[0], tidxs[k], tidxs[k + 1]))

    verts = np.asarray(vs, np.float64)
    nv = len(verts)
    faces = np.asarray(faces_v, np.int64)
    faces = np.where(faces > 0, faces - 1, faces + nv)  # 1-based, or negative from the end

    tex = fvt = uvs_raw = None
    if mtl_file and vts and len(faces_vt) == len(faces_v):
        tex = _load_mtl_texture(path.parent / mtl_file)
        if tex is not None:
            uvs_raw = np.asarray(vts, np.float64)
            fvt = np.asarray(faces_vt, np.int64)
            fvt = np.where(fvt > 0, fvt - 1, fvt + len(uvs_raw))

    colors = vertex_uvs = texture_u8 = None
    if tex is not None:
        if bake_texture:
            colors = _bake_vertex_colors(nv, faces, fvt, uvs_raw, tex)
        else:
            pairs = np.stack([faces.reshape(-1), fvt.reshape(-1)], axis=1)
            uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
            verts = verts[uniq[:, 0]]
            uv = uvs_raw[uniq[:, 1]]
            # OBJ v is GL convention (v up); flip to image rows.
            vertex_uvs = np.stack([_wrap_unit(uv[:, 0]), 1.0 - _wrap_unit(uv[:, 1])], axis=-1)
            vertex_uvs = vertex_uvs.astype(np.float32)
            faces = inv.reshape(-1, 3)
            texture_u8 = (np.clip(tex, 0, 1) * 255).astype(np.uint8)

    return TriMesh(
        vertices=verts.astype(np.float32),
        faces=faces.astype(np.int32),
        vertex_colors=colors,
        vertex_uvs=vertex_uvs,
        texture=texture_u8,
    )


def _load_mtl_texture(mtl_path: Path) -> np.ndarray | None:
    """The first `map_Kd` image of a material file, `[H, W, 3]` float in
    [0, 1], or None."""
    if not mtl_path.exists():
        return None
    tex_file = None
    with open(mtl_path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if tok and tok[0].lower() == "map_kd":
                tex_file = tok[-1]
                break
    if tex_file is None or not (mtl_path.parent / tex_file).exists():
        return None
    return _read_rgb(mtl_path.parent / tex_file).astype(np.float32) / 255.0


def _bake_vertex_colors(nv, faces, faces_vt, uvs, tex) -> np.ndarray:
    """Average the texel colour of each vertex's texcoords over its face
    corners."""
    H, W, _ = tex.shape
    colors = np.zeros((nv, 3), np.float64)
    counts = np.zeros((nv, 1), np.float64)
    uv = uvs[faces_vt.reshape(-1)]  # [F*3, 2]
    u = np.clip((uv[:, 0] % 1.0) * (W - 1), 0, W - 1).astype(np.int64)
    v = np.clip(((1.0 - uv[:, 1]) % 1.0) * (H - 1), 0, H - 1).astype(np.int64)
    vidx = faces.reshape(-1)
    np.add.at(colors, vidx, tex[v, u])
    np.add.at(counts, vidx, 1.0)
    return (colors / np.maximum(counts, 1.0)).astype(np.float32)


def bake_texture_to_colors(mesh: TriMesh) -> TriMesh:
    """Vertex colours from the texel at each vertex uv; drops the texture."""
    if mesh.texture is None or mesh.vertex_uvs is None:
        return mesh
    H, W, _ = mesh.texture.shape
    u = np.clip(mesh.vertex_uvs[:, 0] * (W - 1), 0, W - 1).astype(np.int64)
    v = np.clip(mesh.vertex_uvs[:, 1] * (H - 1), 0, H - 1).astype(np.int64)
    colors = mesh.texture[v, u].astype(np.float32) / 255.0
    return dataclasses.replace(mesh, vertex_colors=colors, vertex_uvs=None, texture=None)


def load_mesh(path: str | Path, **kw) -> TriMesh:
    """Load a PLY or OBJ mesh by extension (`kw` goes to `load_obj`)."""
    suffix = Path(path).suffix.lower()
    if suffix == ".ply":
        return load_ply(path)
    if suffix == ".obj":
        return load_obj(path, **kw)
    raise ValueError(f"unsupported mesh format: {path}")


def simplify_vertex_clustering(mesh: TriMesh, target_faces: int) -> TriMesh:
    """Reduce the face count to at most `target_faces` by uniform-grid vertex
    clustering, with a binary search on the cell size. Through the native
    library (`native/meshproc.cc`, as the JAX package does) where it builds,
    which numbers the vertices and faces as the JAX package's build; else
    with numpy (the same triangles in another order)."""
    if mesh.n_faces <= target_faces:
        return mesh
    from .. import native

    if native.meshproc_available():
        v, f, c = native.simplify_mesh(mesh.vertices, mesh.faces, mesh.vertex_colors, target_faces)
        return TriMesh(vertices=v, faces=f, vertex_colors=c).with_computed_normals()
    lo, hi = 1e-5, 1.0
    ext = float(np.linalg.norm(mesh.vertices.max(0) - mesh.vertices.min(0)))
    best = None
    for _ in range(32):
        cell = (lo + hi) / 2
        m = _cluster_once(mesh, cell * ext)
        if m.n_faces > target_faces:
            lo = cell
        else:
            best = m
            hi = cell
    return best if best is not None else _cluster_once(mesh, hi * ext)


def _cluster_once(mesh: TriMesh, cell: float) -> TriMesh:
    v = mesh.vertices
    keys = np.floor((v - v.min(0)) / max(cell, 1e-12)).astype(np.int64)
    flat = keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791
    uniq, inv = np.unique(flat, return_inverse=True)
    inv = inv.reshape(-1)
    pos = np.zeros((len(uniq), 3), np.float64)
    cnt = np.zeros((len(uniq), 1), np.float64)
    np.add.at(pos, inv, v)
    np.add.at(cnt, inv, 1.0)
    pos = (pos / cnt).astype(np.float32)

    new_faces = inv[mesh.faces]
    keep = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 0] != new_faces[:, 2])
    )
    colors = None
    if mesh.vertex_colors is not None:
        c = np.zeros((len(uniq), 3), np.float64)
        np.add.at(c, inv, mesh.vertex_colors)
        colors = (c / cnt).astype(np.float32)
    out = TriMesh(vertices=pos, faces=new_faces[keep].astype(np.int32), vertex_colors=colors)
    return out.with_computed_normals()


TEXTURE_SIZE, TEXTURE_CELLS = 192, 24


def make_random_texture(size: int = 128, cells: int = 16, seed: int = 0) -> np.ndarray:
    """Random block texture `[size, size, 3]` uint8: `cells x cells` blocks
    of colours drawn uniformly in [0.1, 1] by `np.random.RandomState(seed)`
    (the textured primitives take 192 and 24)."""
    rng = np.random.RandomState(seed)
    blocks = rng.uniform(0.1, 1.0, size=(cells, cells, 3))
    up = size // cells
    return (np.kron(blocks, np.ones((up, up, 1))) * 255).astype(np.uint8)


def make_cube(half_extent: float = 0.05, color=(0.8, 0.2, 0.2), textured: bool = False,
              seed: int = 0) -> TriMesh:
    """Flat-shaded cube: 24 vertices (4 per side) so vertex normals are the
    true face normals. With `textured=True` side `f` maps to tile
    `(f % 3, f // 3)` of a 3x2 atlas of the random block texture of `seed`
    (inset by 1/128 so bilinear lookups stay in the tile)."""
    h = half_extent
    verts, normals, faces = [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            u = np.zeros(3)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            base = len(verts)
            for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                verts.append(n * h + u * su * h + v * sv * h)
                normals.append(n)
            faces.append([base, base + 1, base + 2])
            faces.append([base, base + 2, base + 3])
    verts = np.asarray(verts, np.float32)
    uvs = texture = None
    if textured:
        uvs = np.zeros((24, 2), np.float32)
        pad = 1.0 / 128.0
        for f in range(6):
            fx, fy = f % 3, f // 3
            u0, u1 = fx / 3 + pad, (fx + 1) / 3 - pad
            v0, v1 = fy / 2 + pad, (fy + 1) / 2 - pad
            uvs[4 * f : 4 * f + 4] = [[u0, v0], [u1, v0], [u1, v1], [u0, v1]]
        texture = make_random_texture(TEXTURE_SIZE, TEXTURE_CELLS, seed)
    return TriMesh(
        verts,
        np.asarray(faces, np.int32),
        vertex_normals=np.asarray(normals, np.float32),
        vertex_colors=np.tile(np.asarray(color, np.float32), (len(verts), 1)),
        vertex_uvs=uvs,
        texture=texture,
    )


def make_uv_sphere(
    radius: float = 0.05, n_lat: int = 16, n_lon: int = 24, color=(0.2, 0.4, 0.8), textured: bool = False,
    seed: int = 1,
) -> TriMesh:
    """UV sphere with pole rings collapsed to single triangles. With
    `textured=True` the longitude seam column is duplicated (uv = lon
    column / n_lon, lat / pi) and the random block texture of `seed` is
    attached."""
    n_col = n_lon + 1 if textured else n_lon
    lats = np.linspace(0, np.pi, n_lat + 1)
    # Untextured: endpoint included, as in the JAX package.
    lons = np.linspace(0, 2 * np.pi, n_col, endpoint=not textured)
    verts = np.asarray(
        [
            [radius * np.sin(th) * np.cos(ph), radius * np.sin(th) * np.sin(ph), radius * np.cos(th)]
            for th in lats
            for ph in lons
        ],
        np.float32,
    )
    uvs = None
    if textured:
        uvs = np.asarray([[k / n_lon, th / np.pi] for th in lats for k in range(n_col)], np.float32)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            jn = j + 1 if textured else (j + 1) % n_lon
            a, b = i * n_col + j, i * n_col + jn
            c, d = (i + 1) * n_col + j, (i + 1) * n_col + jn
            if i > 0:  # ring-0 vertices are all the pole
                faces.append([a, c, b])
            if i < n_lat - 1:  # the last ring collapses to the south pole
                faces.append([b, c, d])
    return TriMesh(
        verts,
        np.asarray(faces, np.int32),
        vertex_colors=np.tile(np.asarray(color, np.float32), (len(verts), 1)),
        vertex_uvs=uvs,
        texture=make_random_texture(TEXTURE_SIZE, TEXTURE_CELLS, seed) if textured else None,
    ).with_computed_normals()


def make_cylinder(radius: float = 0.02, length: float = 0.1, n_seg: int = 24, color=(0.4, 0.7, 0.3),
                  textured: bool = False, seed: int = 2) -> TriMesh:
    """Closed cylinder along +z. With `textured=True` the side wraps u =
    angle over the atlas' lower band (seam column duplicated) and each cap
    is a disc of its own in the upper band, with the random block texture
    of `seed`."""
    if textured:
        return _textured_cylinder(radius, length, n_seg, seed)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], -1)
    bot = np.concatenate([ring, np.full((n_seg, 1), -length / 2)], -1)
    top = np.concatenate([ring, np.full((n_seg, 1), length / 2)], -1)
    verts = np.concatenate([bot, top, [[0, 0, -length / 2], [0, 0, length / 2]]]).astype(np.float32)
    faces = []
    cb, ct = 2 * n_seg, 2 * n_seg + 1
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces += [[i, j, n_seg + i], [j, n_seg + j, n_seg + i]]  # side
        faces += [[cb, j, i], [ct, n_seg + i, n_seg + j]]  # caps
    return TriMesh(verts, np.asarray(faces, np.int32),
                   vertex_colors=np.tile(np.asarray(color, np.float32), (len(verts), 1))).with_computed_normals()


def _textured_cylinder(radius: float, length: float, n_seg: int, seed: int) -> TriMesh:
    ang = np.linspace(0, 2 * np.pi, n_seg + 1)  # duplicated seam column
    cx, sy = np.cos(ang) * radius, np.sin(ang) * radius
    pad = 1.0 / 128.0
    verts, uvs, faces = [], [], []
    for row, z in enumerate((-length / 2, length / 2)):  # side: v-band [pad, 0.66]
        for j in range(n_seg + 1):
            verts.append([cx[j], sy[j], z])
            uvs.append([pad + (1 - 2 * pad) * j / n_seg, pad + (0.66 - 2 * pad) * row])
    for j in range(n_seg):
        a, b, c, d = j, j + 1, (n_seg + 1) + j, (n_seg + 1) + j + 1
        faces += [[a, b, c], [b, d, c]]
    for s, (z, cu) in enumerate(((-length / 2, 0.25), (length / 2, 0.75))):  # caps: own rims
        base = len(verts)
        for j in range(n_seg):
            verts.append([cx[j], sy[j], z])
            uvs.append([cu + 0.11 * np.cos(ang[j]), 0.84 + 0.11 * np.sin(ang[j])])
        verts.append([0.0, 0.0, z])
        uvs.append([cu, 0.84])
        center = base + n_seg
        for j in range(n_seg):
            jn = (j + 1) % n_seg
            # The bottom cap faces -z, the top +z.
            faces.append([center, base + jn, base + j] if s == 0 else [center, base + j, base + jn])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                   vertex_colors=np.full((len(verts), 3), 0.7, np.float32),
                   vertex_uvs=np.asarray(uvs, np.float32),
                   texture=make_random_texture(TEXTURE_SIZE, TEXTURE_CELLS, seed)).with_computed_normals()


def make_cone(radius: float = 0.02, height: float = 0.06, n_seg: int = 24, color=(0.8, 0.6, 0.2),
              textured: bool = False, seed: int = 3) -> TriMesh:
    """Closed cone, apex at +z. With `textured=True` the slanted side maps u
    = angle, v = height over the atlas' lower band (seam column and apex
    duplicated per column) and the base is a disc in the upper band, with
    the random block texture of `seed`."""
    if textured:
        return _textured_cone(radius, height, n_seg, seed)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    base = np.stack([np.cos(ang) * radius, np.sin(ang) * radius, np.zeros(n_seg)], -1)
    verts = np.concatenate([base, [[0, 0, height], [0, 0, 0]]]).astype(np.float32)
    apex, center = n_seg, n_seg + 1
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces += [[i, j, apex], [center, j, i]]
    return TriMesh(verts, np.asarray(faces, np.int32),
                   vertex_colors=np.tile(np.asarray(color, np.float32), (len(verts), 1))).with_computed_normals()


def _textured_cone(radius: float, height: float, n_seg: int, seed: int) -> TriMesh:
    ang = np.linspace(0, 2 * np.pi, n_seg + 1)  # duplicated seam column
    cx, sy = np.cos(ang) * radius, np.sin(ang) * radius
    pad = 1.0 / 128.0
    verts, uvs, faces = [], [], []
    for j in range(n_seg + 1):  # base ring row
        verts.append([cx[j], sy[j], 0.0])
        uvs.append([pad + (1 - 2 * pad) * j / n_seg, 0.66 - pad])
    for j in range(n_seg + 1):  # an apex per column
        verts.append([0.0, 0.0, height])
        uvs.append([pad + (1 - 2 * pad) * j / n_seg, pad])
    for j in range(n_seg):
        faces.append([j, j + 1, (n_seg + 1) + j])
    cap = len(verts)  # the base cap's own rim
    for j in range(n_seg):
        verts.append([cx[j], sy[j], 0.0])
        uvs.append([0.5 + 0.11 * np.cos(ang[j]), 0.84 + 0.11 * np.sin(ang[j])])
    verts.append([0.0, 0.0, 0.0])
    uvs.append([0.5, 0.84])
    center = cap + n_seg
    for j in range(n_seg):
        faces.append([center, cap + (j + 1) % n_seg, cap + j])  # faces -z
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                   vertex_colors=np.full((len(verts), 3), 0.7, np.float32),
                   vertex_uvs=np.asarray(uvs, np.float32),
                   texture=make_random_texture(TEXTURE_SIZE, TEXTURE_CELLS, seed)).with_computed_normals()


def make_axes(length: float = 0.1, radius_ratio: float = 0.03) -> TriMesh:
    """RGB x, y, z axes as one mesh: three cylinders of `make_cylinder`
    (12 segments), each with its base at the origin."""
    r = length * radius_ratio
    verts, faces, colors, offset = [], [], [], 0
    for axis, color in ((0, (0.9, 0.1, 0.1)), (1, (0.1, 0.9, 0.1)), (2, (0.1, 0.1, 0.9))):
        cyl = make_cylinder(r, length, 12, color)
        v = cyl.vertices.copy()
        v[:, 2] += length / 2  # base at the origin
        if axis == 0:
            v = v[:, [2, 1, 0]] * np.asarray([1, 1, -1], np.float32)
        elif axis == 1:
            v = v[:, [0, 2, 1]] * np.asarray([1, 1, -1], np.float32)
        verts.append(v)
        faces.append(cyl.faces + offset)
        colors.append(cyl.vertex_colors)
        offset += len(v)
    return TriMesh(np.concatenate(verts), np.concatenate(faces).astype(np.int32),
                   vertex_colors=np.concatenate(colors)).with_computed_normals()


def save_ply(mesh: TriMesh, path: str | Path) -> Path:
    """ASCII PLY: positions, normals (computed if absent), uint8 vertex
    colours when present and, for a textured mesh, `texture_u` /
    `texture_v` (GL convention, v up) with a `comment TextureFile
    <stem>.png` line and the texture written beside it (the convention of
    BOP's textured models, which `load_ply` reads back). The same file as
    the JAX package's `save_ply`; the texture PNG holds the same pixels."""
    mesh = mesh.with_computed_normals()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    has_color = mesh.vertex_colors is not None
    has_tex = mesh.vertex_uvs is not None and mesh.texture is not None
    lines = ["ply", "format ascii 1.0"]
    if has_tex:
        tex_name = path.stem + ".png"
        write_png(path.parent / tex_name, mesh.texture)
        lines.append(f"comment TextureFile {tex_name}")
    lines += [f"element vertex {mesh.n_vertices}"] + [f"property float {c}" for c in ("x", "y", "z", "nx", "ny", "nz")]
    if has_color:
        lines += [f"property uchar {c}" for c in ("red", "green", "blue")]
    if has_tex:
        lines += ["property float texture_u", "property float texture_v"]
    lines += [f"element face {mesh.n_faces}", "property list uchar int vertex_indices", "end_header"]
    n = mesh.vertex_normals
    c8 = np.clip(mesh.vertex_colors * 255.0, 0, 255).astype(np.uint8) if has_color else None
    uv_gl = np.stack([mesh.vertex_uvs[:, 0], 1.0 - mesh.vertex_uvs[:, 1]], axis=-1) if has_tex else None
    rows = []
    for i, v in enumerate(mesh.vertices):
        row = f"{v[0]} {v[1]} {v[2]} {n[i][0]} {n[i][1]} {n[i][2]}"
        if has_color:
            row += f" {c8[i][0]} {c8[i][1]} {c8[i][2]}"
        if has_tex:
            row += f" {uv_gl[i][0]} {uv_gl[i][1]}"
        rows.append(row)
    rows += [f"3 {f[0]} {f[1]} {f[2]}" for f in mesh.faces]
    path.write_text("\n".join(lines + rows) + "\n")
    return path
