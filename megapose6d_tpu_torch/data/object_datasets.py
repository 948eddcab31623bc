"""GSO, ShapeNet, ModelNet and directory object datasets.

Counterpart of `megapose6d_tpu/data/object_datasets.py`: directory
scanners that make `RigidObjectDataset`s with the JAX package's labels.
Their `.obj` meshes are read by `meshes/io.load_obj`, textures baked into
vertex colours.
"""

from __future__ import annotations

from pathlib import Path

from ..meshes.mesh_db import RigidObject, RigidObjectDataset


def make_gso_object_dataset(gso_dir: str | Path, n_objects: int | None = None) -> RigidObjectDataset:
    """Google Scanned Objects, `<gso_dir>/<name>/meshes/model.obj`, in
    metres, labelled `gso_<name>`."""
    objects = []
    for entry in sorted(Path(gso_dir).iterdir()):
        mesh = entry / "meshes" / "model.obj"
        if mesh.exists():
            objects.append(RigidObject(label=f"gso_{entry.name}", mesh_path=mesh, mesh_units="m"))
        if n_objects is not None and len(objects) >= n_objects:
            break
    return RigidObjectDataset(objects)


def make_shapenet_object_dataset(shapenet_dir: str | Path, n_objects: int | None = None,
                                 taxonomy_filter: set[str] | None = None) -> RigidObjectDataset:
    """ShapeNetCore v2, `<dir>/<synset>/<model>/models/model_normalized.obj`,
    in metres, labelled `shapenet_<synset>_<model>`."""
    objects = []
    for synset in sorted(Path(shapenet_dir).iterdir()):
        if not synset.is_dir() or (taxonomy_filter and synset.name not in taxonomy_filter):
            continue
        for model in sorted(synset.iterdir()):
            mesh = model / "models" / "model_normalized.obj"
            if mesh.exists():
                objects.append(RigidObject(label=f"shapenet_{synset.name}_{model.name}", mesh_path=mesh,
                                           mesh_units="m"))
            if n_objects is not None and len(objects) >= n_objects:
                return RigidObjectDataset(objects)
    return RigidObjectDataset(objects)


def make_modelnet_object_dataset(modelnet_dir: str | Path, category: str, split: str = "test",
                                 n_objects: int | None = None) -> RigidObjectDataset:
    """ModelNet40, `<dir>/<category>/<split>/<category>_NNNN.obj`, in
    metres, labelled `modelnet_<category>_<stem>`."""
    objects = []
    for mesh in sorted((Path(modelnet_dir) / category / split).glob("*.obj")):
        objects.append(RigidObject(label=f"modelnet_{category}_{mesh.stem}", mesh_path=mesh, mesh_units="m"))
        if n_objects is not None and len(objects) >= n_objects:
            break
    return RigidObjectDataset(objects)


def make_directory_object_dataset(mesh_dir: str | Path, mesh_units: str = "mm") -> RigidObjectDataset:
    """Every `.ply` and `.obj` of a flat directory, labelled by file stem."""
    objects = [RigidObject(label=mesh.stem, mesh_path=mesh, mesh_units=mesh_units)
               for mesh in sorted(Path(mesh_dir).iterdir()) if mesh.suffix.lower() in (".ply", ".obj")]
    return RigidObjectDataset(objects)
