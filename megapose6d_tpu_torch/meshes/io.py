"""Mesh loading and preprocessing (host-side numpy).

Counterpart of `megapose6d_tpu/meshes/io.py` for PLY meshes with vertex
colours. Texture images are not read (textured rendering waits), so the
port needs no image library.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class TriMesh:
    """A triangle mesh with per-vertex attributes (float32/int32)."""

    vertices: np.ndarray  # [V, 3]
    faces: np.ndarray  # [F, 3]
    vertex_normals: np.ndarray | None = None  # [V, 3]
    vertex_colors: np.ndarray | None = None  # [V, 3] in [0, 1]

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
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append(("scalar", tok[1], tok[2]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}: {path}")

    verts = normals = colors = faces = None
    if fmt == "ascii":
        rows = body.decode("ascii").split("\n")
        cursor = 0
        for name, count, props in elements:
            chunk = rows[cursor : cursor + count]
            cursor += count
            if name == "vertex":
                arr = np.array([r.split() for r in chunk], dtype=np.float64)
                verts, normals, colors = _extract_vertex_cols(arr, [p[2] for p in props])
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
                    verts, normals, colors = _extract_vertex_cols(flat, cols)
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
    return TriMesh(
        vertices=verts.astype(np.float32),
        faces=faces.astype(np.int32),
        vertex_normals=None if normals is None else normals.astype(np.float32),
        vertex_colors=None if colors is None else colors.astype(np.float32),
    )


def _extract_vertex_cols(arr, cols):
    def get(names):
        idx = [cols.index(n) for n in names if n in cols]
        return arr[:, idx] if len(idx) == len(names) else None

    colors = get(["red", "green", "blue"])
    if colors is not None and colors.max() > 1.0:
        colors = colors / 255.0
    return get(["x", "y", "z"]), get(["nx", "ny", "nz"]), colors


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


def load_mesh(path: str | Path) -> TriMesh:
    """Load a mesh by extension (PLY; OBJ waits with textures)."""
    if Path(path).suffix.lower() != ".ply":
        raise NotImplementedError(f"only PLY meshes are read by the port: {path}")
    return load_ply(path)


def simplify_vertex_clustering(mesh: TriMesh, target_faces: int) -> TriMesh:
    """Reduce the face count to at most `target_faces` by uniform-grid vertex
    clustering, with a binary search on the cell size."""
    if mesh.n_faces <= target_faces:
        return mesh
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


def make_cube(half_extent: float = 0.05, color=(0.8, 0.2, 0.2)) -> TriMesh:
    """Flat-shaded cube: 24 vertices (4 per side) so vertex normals are the
    true face normals."""
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
    return TriMesh(
        verts,
        np.asarray(faces, np.int32),
        vertex_normals=np.asarray(normals, np.float32),
        vertex_colors=np.tile(np.asarray(color, np.float32), (len(verts), 1)),
    )


def make_uv_sphere(
    radius: float = 0.05, n_lat: int = 16, n_lon: int = 24, color=(0.2, 0.4, 0.8)
) -> TriMesh:
    """UV sphere with pole rings collapsed to single triangles."""
    lats = np.linspace(0, np.pi, n_lat + 1)
    lons = np.linspace(0, 2 * np.pi, n_lon)  # endpoint included, as in the JAX package
    verts = np.asarray(
        [
            [radius * np.sin(th) * np.cos(ph), radius * np.sin(th) * np.sin(ph), radius * np.cos(th)]
            for th in lats
            for ph in lons
        ],
        np.float32,
    )
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            jn = (j + 1) % n_lon
            a, b = i * n_lon + j, i * n_lon + jn
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + jn
            if i > 0:  # ring-0 vertices are all the pole
                faces.append([a, c, b])
            if i < n_lat - 1:  # the last ring collapses to the south pole
                faces.append([b, c, d])
    return TriMesh(
        verts,
        np.asarray(faces, np.int32),
        vertex_colors=np.tile(np.asarray(color, np.float32), (len(verts), 1)),
    ).with_computed_normals()
