"""Mesh preprocessing CLI: an object set -> the padded mesh database in
one npz.

Counterpart of `megapose6d_tpu/scripts/preprocess_meshes.py`: load,
decimate, Morton-order and pad once, and write the database in the JAX
package's npz layout (`meshes/mesh_db.save_batched_meshes`), which
`load_batched_meshes` of either package reads.

    python -m megapose6d_tpu_torch.scripts.preprocess_meshes \\
        source=bop:ycbv out=ycbv_meshdb.npz max_faces=4096
    python -m megapose6d_tpu_torch.scripts.preprocess_meshes \\
        source=dir:runs/ar_baseline/synthdemo/models out=synthdemo.npz

Sources: `bop:<name>` (any `data/datasets_cfg.make_object_dataset` name),
`gso:<dir>`, `shapenet:<dir>` (with `n_objects=`) and `dir:<dir>` (meshes
in millimetres). The work is on the host: the database is built on the
CPU and written from there.
"""

from __future__ import annotations

import logging
import sys

from ..meshes.mesh_db import BatchedMeshes, MeshDataBase, save_batched_meshes

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> BatchedMeshes:
    args = dict(source="", out="meshdb.npz", max_faces="4096", n_points="2000", n_sym="32", n_objects="0")
    for a in sys.argv[1:] if argv is None else argv:
        k, _, v = a.partition("=")
        if k not in args:
            raise ValueError(f"unknown argument {k!r}; known: {sorted(args)}")
        args[k] = v
    kind, _, spec = args["source"].partition(":")
    n_obj = int(args["n_objects"]) or None
    if kind == "bop":
        from ..data.datasets_cfg import make_object_dataset

        objects = make_object_dataset(spec)
    elif kind == "gso":
        from ..data.object_datasets import make_gso_object_dataset

        objects = make_gso_object_dataset(spec, n_objects=n_obj)
    elif kind == "shapenet":
        from ..data.object_datasets import make_shapenet_object_dataset

        objects = make_shapenet_object_dataset(spec, n_objects=n_obj)
    elif kind == "dir":
        from ..data.object_datasets import make_directory_object_dataset

        objects = make_directory_object_dataset(spec)
    else:
        raise ValueError(f"unknown source kind: {kind!r}")
    logger.info("loading and preprocessing %d meshes...", len(objects.labels))
    db = MeshDataBase.from_object_ds(objects, max_faces=int(args["max_faces"]), n_points=int(args["n_points"]),
                                     n_sym=int(args["n_sym"]))
    batched = db.batched(device="cpu")
    save_batched_meshes(args["out"], batched)
    logger.info("wrote %s: %d objects, V=%d, F=%d", args["out"], len(batched.labels), batched.vertices.shape[1],
                batched.faces.shape[1])
    return batched


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
