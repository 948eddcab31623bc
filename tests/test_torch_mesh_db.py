"""Port vs JAX: a mesh database built by the port equals the JAX one
array for array (exactly: both run the same numpy preprocessing), for
procedural meshes with symmetries and for the committed BOP models."""

from pathlib import Path

import numpy as np
import pytest

from megapose6d_tpu.meshes import io as jio
from megapose6d_tpu.meshes import mesh_db as jdb
from megapose6d_tpu.ops import symmetries as jsym
from megapose6d_tpu_torch.meshes import io as tio
from megapose6d_tpu_torch.meshes import mesh_db as tdb
from megapose6d_tpu_torch.ops import symmetries as tsym

MODELS = Path(__file__).resolve().parents[1] / "runs/ar_baseline/synthdemo/models"
FIELDS = ("vertices", "normals", "colors", "faces", "face_valid", "points",
          "symmetries", "sym_valid", "diameters")


def assert_same_db(j, t):
    assert tuple(j.labels) == tuple(t.labels)
    for k in FIELDS:
        a, b = np.asarray(getattr(j, k)), getattr(t, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_procedural_db_matches_jax():
    def objects(io, sym):
        return [
            dict(label="cube", mesh=io.make_cube(0.04),
                 symmetries_discrete=[sym.DiscreteSymmetry(pose=np.diag([-1.0, -1, 1, 1]))]),
            dict(label="sphere", mesh=io.make_uv_sphere(0.035, 8, 12),
                 symmetries_continuous=[sym.ContinuousSymmetry(axis=np.array([0.0, 0, 1]))]),
        ]

    j = jdb.MeshDataBase.from_object_ds(
        jdb.RigidObjectDataset([jdb.RigidObject(**o) for o in objects(jio, jsym)]),
        max_faces=256, n_points=64, n_sym=16).batched(align=32)
    t = tdb.MeshDataBase.from_object_ds(
        tdb.RigidObjectDataset([tdb.RigidObject(**o) for o in objects(tio, tsym)]),
        max_faces=256, n_points=64, n_sym=16).batched(align=32, device="cpu")
    assert_same_db(j, t)
    assert t.sym_valid[1].sum() == 8  # 8 samples of the continuous symmetry
    idx = t.label_to_index(["sphere", "cube", "sphere"])
    sel = t.select(idx)
    np.testing.assert_array_equal(np.asarray(j.select(np.asarray(idx)).faces), sel.faces.numpy())
    assert tuple(sel.vertices.shape) == (3,) + tuple(t.vertices.shape[1:])


def test_bop_models_db_matches_jax():
    """The committed PLY models (mm units; the port skips their texture
    image, the JAX DB keeps it beside identical vertex colors)."""
    def objects(db):
        return db.RigidObjectDataset(
            [db.RigidObject(label=p.stem, mesh_path=p, mesh_units="mm")
             for p in sorted(MODELS.glob("*.ply"))])

    j = jdb.MeshDataBase.from_object_ds(objects(jdb), max_faces=4096, n_points=2000, n_sym=32)
    t = tdb.MeshDataBase.from_object_ds(objects(tdb), max_faces=4096, n_points=2000, n_sym=32)
    assert_same_db(j.batched(), t.batched(device="cpu"))


@pytest.mark.parametrize("ascii_format", [True, False])
def test_load_ply_matches_jax(tmp_path, ascii_format):
    mesh = jio.make_uv_sphere(0.05, 6, 8)
    path = jio.save_ply(mesh, tmp_path / "m.ply")
    if not ascii_format:  # rewrite as binary little endian
        v = mesh.vertices
        f = mesh.faces
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\nproperty float x\nproperty float y\nproperty float z\n"
            f"element face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n"
        ).encode()
        rows = b"".join(np.uint8(3).tobytes() + r.astype("<i4").tobytes() for r in f)
        path.write_bytes(header + v.astype("<f4").tobytes() + rows)
    a, b = jio.load_ply(path), tio.load_ply(path)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    for k in ("vertex_normals", "vertex_colors"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def test_simplify_and_normals_match_jax_numpy_path():
    """Vertex clustering against the JAX package's numpy implementation."""
    mesh = jio.make_uv_sphere(0.05, 24, 32)
    tm = tio.TriMesh(mesh.vertices, mesh.faces, vertex_colors=mesh.vertex_colors)
    np.testing.assert_array_equal(
        jio.compute_vertex_normals(mesh.vertices, mesh.faces),
        tio.compute_vertex_normals(mesh.vertices, mesh.faces))
    cell = 0.01
    a = jio._cluster_once(mesh, cell)
    b = tio._cluster_once(tm, cell)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    s = tio.simplify_vertex_clustering(tm, 300)
    assert 0 < s.n_faces <= 300
