"""Mesh IO and the padded mesh database."""

from .io import (  # noqa: F401
    TriMesh,
    load_mesh,
    load_obj,
    load_ply,
    make_axes,
    make_cone,
    make_cube,
    make_cylinder,
    make_uv_sphere,
    save_ply,
    simplify_vertex_clustering,
)
from .mesh_db import BatchedMeshes, MeshDataBase, RigidObject, RigidObjectDataset  # noqa: F401
