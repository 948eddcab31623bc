"""Object registry and the padded mesh database.

Counterpart of `megapose6d_tpu/meshes/mesh_db.py` without textures. All
meshes are padded to one vertex and face count so that `select` assembles
the per-hypothesis mesh batch with one gather on the device. Padding:
  - vertices/normals/colors padded with the last valid vertex,
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
from .io import TriMesh, load_mesh, simplify_vertex_clustering


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

    @property
    def scale(self) -> float:
        return {"m": 1.0, "mm": 0.001}[self.mesh_units] * self.scaling_factor

    def load(self) -> TriMesh:
        mesh = self.mesh
        if mesh is None:
            if self.mesh_path is None:
                raise ValueError(f"object {self.label!r} has neither mesh nor mesh_path")
            mesh = load_mesh(self.mesh_path)
        mesh = mesh.scaled(self.scale).with_computed_normals()
        if mesh.vertex_colors is None:
            mesh = dataclasses.replace(mesh, vertex_colors=np.full_like(mesh.vertices, 0.5))
        return mesh


class RigidObjectDataset:
    """Label-indexed collection of objects."""

    def __init__(self, objects: Sequence[RigidObject]):
        self.objects = list(objects)
        if len({o.label for o in self.objects}) != len(self.objects):
            raise ValueError("duplicate object labels")

    @property
    def labels(self) -> list[str]:
        return [o.label for o in self.objects]


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

    _TENSORS = (
        "vertices", "normals", "colors", "faces", "face_valid",
        "points", "symmetries", "sym_valid", "diameters",
    )

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def label_to_index(self, labels: Sequence[str]) -> torch.Tensor:
        table = {l: i for i, l in enumerate(self.labels)}
        return torch.tensor([table[l] for l in labels], dtype=torch.long, device=self.device)

    def select(self, idx: torch.Tensor) -> "BatchedMeshes":
        """Gather a batch `[B, ...]` of meshes by label index `idx [B]`."""
        return BatchedMeshes(
            **{k: getattr(self, k)[idx] for k in self._TENSORS}, labels=self.labels
        )

    def repeat_interleave(self, n: int) -> "BatchedMeshes":
        """Each mesh `n` times in a row (one per rendered view)."""
        return BatchedMeshes(
            **{k: getattr(self, k).repeat_interleave(n, dim=0) for k in self._TENSORS},
            labels=self.labels,
        )


class MeshDataBase:
    """Host-side mesh DB; `batched()` produces the device `BatchedMeshes`."""

    def __init__(
        self,
        objects: RigidObjectDataset,
        max_faces: int = 4096,
        n_points: int = 2000,
        n_sym: int = 32,
    ):
        self.objects = objects
        self.max_faces = max_faces
        self.n_points = n_points
        self.n_sym = n_sym
        self.meshes: dict[str, TriMesh] = {}
        self._sym_poses: dict[str, np.ndarray] = {}
        for obj in objects.objects:
            mesh = obj.load()
            if mesh.n_faces > max_faces:
                mesh = simplify_vertex_clustering(mesh, max_faces)
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

    def batched(self, align: int = 128, device: str | torch.device = "cuda") -> BatchedMeshes:
        """Pack to padded tensors on `device`."""
        labels = self.objects.labels
        L = len(labels)
        V = _round_up(max(m.n_vertices for m in self.meshes.values()), align)
        F = _round_up(min(self.max_faces, max(m.n_faces for m in self.meshes.values())), align)
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
        return BatchedMeshes(
            **{k: torch.as_tensor(v, device=device) for k, v in arrays.items()},
            labels=tuple(labels),
        )
