"""The procedural worlds of the demos and of the detector's trainer.

Counterparts of `build_world` (`megapose6d_tpu/scripts/demo_synthetic_e2e.py`)
and `build_bop_world` (`megapose6d_tpu/scripts/demo_ar_baseline.py`), kept
in one module so that the demo scripts and `run_detector_training` share
them. The demo world is the JAX script's: a cube (half extent 4.5 cm) and
a UV sphere (radius 4 cm, 24 x 32) with random block textures from seeds 0
and 1; the novel world a textured cylinder and cone. Mesh databases hold
512 points and 4 symmetries.
"""

from __future__ import annotations

import torch

from .io import make_cone, make_cube, make_cylinder, make_uv_sphere
from .mesh_db import BatchedMeshes, MeshDataBase, RigidObject, RigidObjectDataset


def world_objects(labels: tuple[str, str] = ("cube", "sphere")) -> RigidObjectDataset:
    """The two textured primitives under `labels` (`bop_world_objects`
    names them `obj_000001` and `obj_000002`)."""
    return RigidObjectDataset([
        RigidObject(label=labels[0], mesh=make_cube(0.045, textured=True)),
        RigidObject(label=labels[1], mesh=make_uv_sphere(0.04, 24, 32, textured=True)),
    ])


def build_world(max_faces: int = 2048, device: str | torch.device = "cuda",
                objects: RigidObjectDataset | None = None) -> BatchedMeshes:
    """The world's objects (default `world_objects()`) in a
    `BatchedMeshes` on `device`. At 2048 faces the sphere is not
    decimated; below, decimation bakes its texture into vertex colours."""
    objects = objects or world_objects()
    return MeshDataBase.from_object_ds(objects, max_faces=max_faces, n_points=512, n_sym=4).batched(device=device)


def bop_world_objects(world: str = "demo") -> RigidObjectDataset:
    """The evaluation world under BOP labels: `demo`, the textured cube and
    sphere the demo models were trained on; `novel`, a textured cylinder
    and cone they never saw."""
    if world == "demo":
        return world_objects(("obj_000001", "obj_000002"))
    if world != "novel":
        raise ValueError(f"world must be demo or novel, not {world}")
    return RigidObjectDataset([
        RigidObject(label="obj_000001", mesh=make_cylinder(0.022, 0.09, n_seg=32, textured=True, seed=7)),
        RigidObject(label="obj_000002", mesh=make_cone(0.035, 0.08, n_seg=32, textured=True, seed=8)),
    ])


def build_bop_world(world: str = "demo", device: str | torch.device = "cuda") -> tuple[BatchedMeshes, RigidObjectDataset]:
    """(mesh database of 2048 faces, 512 points, 4 symmetries; objects)."""
    objects = bop_world_objects(world)
    return build_world(device=device, objects=objects), objects
