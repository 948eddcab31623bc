"""Object registry and the padded mesh database.

Counterpart of `megapose6d_tpu/meshes/mesh_db.py`. All meshes are padded
to one vertex and face count so that `select` assembles the per-hypothesis
mesh batch with one gather on the device. Padding:
  - vertices/normals/colors/uvs padded with the last valid vertex,
  - faces padded with (0, 0, 0) and `face_valid=False`,
  - symmetries padded with identity + `sym_valid` mask,
  - points are a random vertex subset, or a cyclic repetition when the
    mesh has fewer vertices than points.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..ops import symmetries as sym_ops
from .io import TriMesh, bake_texture_to_colors, load_mesh, simplify_vertex_clustering

_RESIZE_BITS = 22  # fractional bits of PIL's 8-bit resampling coefficients


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """`[n_out, n_in]` int64 coefficients of PIL's bilinear resampling along
    one axis (`Resample.c`: triangle filter, support scaled by the
    downsampling factor, normalised per output pixel, then fixed point)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle filter's support is 1
    w = np.zeros((n_out, n_in), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        x = np.arange(xmin, xmax)
        k = np.maximum(1.0 - np.abs((x - center + 0.5) / filterscale), 0.0)
        total = k.sum()
        w[xx, xmin:xmax] = k / total if total != 0.0 else k
    return np.trunc(0.5 + w * (1 << _RESIZE_BITS)).astype(np.int64)


def _resample_rows(img: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One PIL pass along axis 0 of uint8 `img`: fixed-point sums, rounded
    and clipped to uint8."""
    acc = np.tensordot(weights, img.astype(np.int64), axes=(1, 0)) + (1 << (_RESIZE_BITS - 1))
    return np.clip(acc >> _RESIZE_BITS, 0, 255).astype(np.uint8)


def _resize_texture(tex: np.ndarray, size: int) -> np.ndarray:
    """Resize a `[H, W, 3]` uint8 texture to `[size, size, 3]`, bit for bit
    as PIL's `Image.resize((size, size), BILINEAR)`: the horizontal pass
    first, then the vertical one, each rounded to uint8."""
    if tex.shape[0] == size and tex.shape[1] == size:
        return tex
    horizontal = _resample_rows(tex.transpose(1, 0, 2), _resize_weights(tex.shape[1], size))
    return _resample_rows(horizontal.transpose(1, 0, 2), _resize_weights(tex.shape[0], size))


@dataclasses.dataclass
class RigidObject:
    """One object asset."""

    label: str
    mesh_path: str | Path | None = None
    mesh: TriMesh | None = None  # pre-loaded alternative to mesh_path
    mesh_units: str = "m"  # "m" | "mm"
    scaling_factor: float = 1.0
    symmetries_discrete: list = dataclasses.field(default_factory=list)
    symmetries_continuous: list = dataclasses.field(default_factory=list)
    ypr_offset_deg: tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def scale(self) -> float:
        return {"m": 1.0, "mm": 0.001}[self.mesh_units] * self.scaling_factor

    def load(self, bake_texture: bool = True) -> TriMesh:
        mesh = self.mesh
        if mesh is None:
            if self.mesh_path is None:
                raise ValueError(f"object {self.label!r} has neither mesh nor mesh_path")
            kw = {}
            if Path(self.mesh_path).suffix.lower() == ".obj":
                kw["bake_texture"] = bake_texture  # an OBJ's texture is baked unless kept
            mesh = load_mesh(self.mesh_path, **kw)
        mesh = mesh.scaled(self.scale).with_computed_normals()
        if mesh.vertex_colors is None:
            mesh = dataclasses.replace(mesh, vertex_colors=np.full_like(mesh.vertices, 0.5))
        return mesh


class RigidObjectDataset:
    """Label-indexed collection of objects."""

    def __init__(self, objects: Sequence[RigidObject]):
        self.objects = list(objects)
        self._by_label = {o.label: o for o in self.objects}
        if len(self._by_label) != len(self.objects):
            raise ValueError("duplicate object labels")

    @property
    def labels(self) -> list[str]:
        return [o.label for o in self.objects]

    def get_object_by_label(self, label: str) -> RigidObject:
        return self._by_label[label]

    def filter_objects(self, keep_labels: set[str]) -> "RigidObjectDataset":
        """The objects whose label is in `keep_labels`, in order."""
        return RigidObjectDataset([o for o in self.objects if o.label in keep_labels])


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _normalize_winding(mesh: TriMesh) -> TriMesh:
    """Flip all faces if the signed volume is negative, so closed meshes are
    outward-CCW (the precondition of the rasterizer's backface cull)."""
    v = mesh.vertices[mesh.faces]
    vol = float(np.einsum("fi,fi->f", v[:, 0], np.cross(v[:, 1], v[:, 2])).sum())
    if vol < 0:
        mesh = dataclasses.replace(mesh, faces=mesh.faces[:, [0, 2, 1]])
    return mesh


def _morton_sort_faces(mesh: TriMesh) -> TriMesh:
    """Reorder faces along a 3D Morton curve of their centroids, so that
    consecutive faces (one chunk of the rasterizer) are spatially close."""
    c = mesh.vertices[mesh.faces].mean(axis=1)
    lo, hi = c.min(0), c.max(0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))
    return dataclasses.replace(mesh, faces=mesh.faces[np.argsort(code, kind="stable")])


@dataclasses.dataclass
class BatchedMeshes:
    """Padded per-label mesh tensors; axis 0 is the label (or, after
    `select`, the hypothesis)."""

    vertices: torch.Tensor  # [L, V, 3] f32
    normals: torch.Tensor  # [L, V, 3] f32
    colors: torch.Tensor  # [L, V, 3] f32
    faces: torch.Tensor  # [L, F, 3] i32
    face_valid: torch.Tensor  # [L, F] bool
    points: torch.Tensor  # [L, P, 3] f32
    symmetries: torch.Tensor  # [L, S, 4, 4] f32
    sym_valid: torch.Tensor  # [L, S] bool
    diameters: torch.Tensor  # [L] f32
    labels: tuple[str, ...]
    # Per-pixel texturing, when some mesh has a texture: per-vertex uv in
    # image convention, one square uint8 texture slot per label, and
    # whether the label samples its texture (else its vertex colours).
    uvs: torch.Tensor | None = None  # [L, V, 2] f32 in [0, 1]
    textures: torch.Tensor | None = None  # [L, TS, TS, 3] u8
    has_tex: torch.Tensor | None = None  # [L] bool

    _TENSORS = (
        "vertices", "normals", "colors", "faces", "face_valid",
        "points", "symmetries", "sym_valid", "diameters",
    )
    _OPTIONAL = ("uvs", "textures", "has_tex")

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def n_labels(self) -> int:
        return self.vertices.shape[0]

    def replace(self, **changes) -> "BatchedMeshes":
        return dataclasses.replace(self, **changes)

    def label_to_index(self, labels: Sequence[str]) -> torch.Tensor:
        table = {l: i for i, l in enumerate(self.labels)}
        return torch.tensor([table[l] for l in labels], dtype=torch.long, device=self.device)

    def _map(self, fn) -> "BatchedMeshes":
        opt = {k: getattr(self, k) for k in self._OPTIONAL}
        return BatchedMeshes(
            **{k: fn(getattr(self, k)) for k in self._TENSORS},
            **{k: None if v is None else fn(v) for k, v in opt.items()},
            labels=self.labels,
        )

    def select(self, idx: torch.Tensor) -> "BatchedMeshes":
        """Gather a batch `[B, ...]` of meshes by label index `idx [B]`."""
        return self._map(lambda x: x[idx])

    def repeat_interleave(self, n: int) -> "BatchedMeshes":
        """Each mesh `n` times in a row (one per rendered view)."""
        return self._map(lambda x: x.repeat_interleave(n, dim=0))

    @property
    def texture_kw(self) -> dict[str, torch.Tensor]:
        """`uvs`, `textures` and `has_tex` for `render_meshes_tiled`, or
        nothing when no mesh is textured."""
        if self.textures is None:
            return {}
        return dict(uvs=self.uvs, textures=self.textures, has_tex=self.has_tex)


class MeshDataBase:
    """Host-side mesh DB; `batched()` produces the device `BatchedMeshes`."""

    def __init__(
        self,
        objects: RigidObjectDataset,
        max_faces: int = 4096,
        n_points: int = 2000,
        n_sym: int = 32,
        keep_textures: bool = True,
        texture_size: int = 256,
    ):
        self.objects = objects
        self.max_faces = max_faces
        self.n_points = n_points
        self.n_sym = n_sym
        self.keep_textures = keep_textures
        self.texture_size = texture_size
        self.meshes: dict[str, TriMesh] = {}
        self._sym_poses: dict[str, np.ndarray] = {}
        for obj in objects.objects:
            mesh = obj.load(bake_texture=not keep_textures)
            if not keep_textures:
                mesh = bake_texture_to_colors(mesh)
            if mesh.n_faces > max_faces:
                # Clustering merges uv seams: bake the texture first.
                mesh = simplify_vertex_clustering(bake_texture_to_colors(mesh), max_faces)
            self.meshes[obj.label] = _morton_sort_faces(_normalize_winding(mesh))
            self._sym_poses[obj.label] = sym_ops.make_symmetries_poses(
                symmetries_discrete=obj.symmetries_discrete,
                symmetries_continuous=obj.symmetries_continuous,
                n_symmetries_continuous=8,
                scale=obj.scale,
            )

    @classmethod
    def from_object_ds(cls, ds: RigidObjectDataset, **kw) -> "MeshDataBase":
        return cls(ds, **kw)

    def pad_targets(self, align: int = 128) -> tuple[int, int]:
        """The vertex and face counts `batched` pads to by default."""
        V = _round_up(max(m.n_vertices for m in self.meshes.values()), align)
        F = _round_up(min(self.max_faces, max(m.n_faces for m in self.meshes.values())), align)
        return V, F

    def batched(self, align: int = 128, n_vertices_pad: int | None = None, n_faces_pad: int | None = None,
                device: str | torch.device = "cuda") -> BatchedMeshes:
        """Pack to padded tensors on `device`. `n_vertices_pad` /
        `n_faces_pad` force the pad targets, so that databases built apart
        (the label shards of `sharded_db.ShardedMeshDB`) agree on shapes."""
        labels = self.objects.labels
        L = len(labels)
        V, F = self.pad_targets(align)
        V, F = n_vertices_pad or V, n_faces_pad or F
        if any(m.n_vertices > V for m in self.meshes.values()):
            raise ValueError(f"n_vertices_pad {V} is below a mesh's vertex count")
        if any(m.n_faces > F for m in self.meshes.values()):
            raise ValueError(f"n_faces_pad {F} is below a mesh's face count")
        P, S = self.n_points, self.n_sym

        verts = np.zeros((L, V, 3), np.float32)
        norms = np.zeros((L, V, 3), np.float32)
        cols = np.zeros((L, V, 3), np.float32)
        faces = np.zeros((L, F, 3), np.int32)
        fvalid = np.zeros((L, F), bool)
        points = np.zeros((L, P, 3), np.float32)
        syms = np.tile(np.eye(4, dtype=np.float32), (L, S, 1, 1))
        svalid = np.zeros((L, S), bool)
        diam = np.zeros((L,), np.float32)
        any_tex = any(m.texture is not None and m.vertex_uvs is not None
                      for m in self.meshes.values())
        TS = self.texture_size
        uvs = np.zeros((L, V, 2), np.float32) if any_tex else None
        texs = np.zeros((L, TS, TS, 3), np.uint8) if any_tex else None
        htex = np.zeros((L,), bool) if any_tex else None

        rng = np.random.RandomState(0)
        for i, label in enumerate(labels):
            m = self.meshes[label]
            nv, nf = m.n_vertices, m.n_faces
            verts[i, :nv] = m.vertices
            verts[i, nv:] = m.vertices[-1]
            norms[i, :nv] = m.vertex_normals
            norms[i, nv:] = m.vertex_normals[-1]
            cols[i, :nv] = m.vertex_colors
            cols[i, nv:] = m.vertex_colors[-1]
            if any_tex and m.texture is not None and m.vertex_uvs is not None:
                uvs[i, :nv] = m.vertex_uvs
                uvs[i, nv:] = m.vertex_uvs[-1]
                texs[i] = _resize_texture(m.texture, TS)
                htex[i] = True
            faces[i, :nf] = m.faces
            fvalid[i, :nf] = True
            idx = rng.choice(nv, P, replace=False) if nv >= P else np.arange(P) % nv
            points[i] = m.vertices[idx]
            sp, sv = sym_ops.pad_symmetries(self._sym_poses[label], S)
            syms[i] = sp.astype(np.float32)
            svalid[i] = sv
            diam[i] = m.diameter()

        arrays = dict(
            vertices=verts, normals=norms, colors=cols, faces=faces, face_valid=fvalid,
            points=points, symmetries=syms, sym_valid=svalid, diameters=diam,
        )
        if any_tex:
            arrays.update(uvs=uvs, textures=texs, has_tex=htex)
        return BatchedMeshes(
            **{k: torch.as_tensor(v, device=device) for k, v in arrays.items()},
            labels=tuple(labels),
        )


def save_batched_meshes(path: str | Path, batched: BatchedMeshes) -> None:
    """A padded mesh database in one compressed npz, in the JAX package's
    layout (`meshes/mesh_db.py save_batched_meshes`): one array per field,
    the optional texture fields only when present, and `labels` as a
    unicode array. Either package reads what the other wrote."""
    arrays = {k: getattr(batched, k).cpu().numpy() for k in BatchedMeshes._TENSORS}
    arrays.update({k: getattr(batched, k).cpu().numpy() for k in BatchedMeshes._OPTIONAL
                   if getattr(batched, k) is not None})
    np.savez_compressed(path, labels=np.asarray(batched.labels), **arrays)


def load_batched_meshes(path: str | Path, device: str | torch.device = "cuda") -> BatchedMeshes:
    """The database `save_batched_meshes` (of either package) wrote, on
    `device`."""
    with np.load(path, allow_pickle=False) as data:
        t = lambda k: torch.as_tensor(data[k]).to(device)  # noqa: E731
        return BatchedMeshes(
            **{k: t(k) for k in BatchedMeshes._TENSORS},
            **{k: t(k) if k in data else None for k in BatchedMeshes._OPTIONAL},
            labels=tuple(str(label) for label in data["labels"]),
        )
