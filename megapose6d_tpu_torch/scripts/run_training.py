"""Training CLI: a `config_id` preset and `key=value` overrides.

Counterpart of `megapose6d_tpu/scripts/run_training.py`, on one device
(`device=`, `cuda` by default). `synthetic=1` trains on scenes of a
procedural cube and sphere rendered on the device. `train_datasets=a,b`
trains on named scene datasets (`data/datasets_cfg.py`, under `data_dir=`
or `MEGAPOSE_DATA_DIR`) through the batch loader (`n_dataloader_workers`
worker processes decode, augment and collate on the host; 0 runs inline),
on the objects of `object_dataset=` (the first training dataset's by
default), the first `n_max_objects` of them if set; no validation.

    python -m megapose6d_tpu_torch.scripts.run_training config_id=refiner synthetic=1 \\
        n_epochs=2 [device=cpu]
    python -m megapose6d_tpu_torch.scripts.run_training config_id=coarse synthetic=1 debug=1
    python -m megapose6d_tpu_torch.scripts.run_training config_id=refiner \\
        train_datasets=synthdemo.bop19 data_dir=runs/ar_dr n_epochs=2 [device=cpu]

writes `<run_dir>/<run_id>/{config.json,log.txt,checkpoints/}`.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from pathlib import Path

from ..data.datasets_cfg import make_object_dataset
from ..data.loader import ParallelBatchLoader, PoseBatchFactory
from ..meshes.io import make_cube, make_uv_sphere
from ..meshes.mesh_db import BatchedMeshes, MeshDataBase, RigidObject, RigidObjectDataset
from ..training.config import (
    TrainingConfig,
    apply_overrides,
    load_config,
    make_coarse_cfg,
    make_refiner_cfg,
    update_cfg_debug,
)
from ..training.train import (
    BATCH_STREAM,
    VAL_BATCH_STREAM,
    TrainState,
    step_generator,
    synthetic_batch_fn,
    train,
)

logger = logging.getLogger(__name__)

# Arguments that are not TrainingConfig fields.
META = {"config_id": "refiner", "debug": "0", "synthetic": "0", "device": "cuda", "object_dataset": "",
        "data_dir": ""}


def make_config(config_id: str, debug: bool, overrides: list[str]) -> TrainingConfig:
    """The preset of `config_id` with `overrides`; a resumed run starts from
    its saved config.json, then the overrides apply again."""
    if config_id.startswith("refiner"):
        cfg = make_refiner_cfg(TrainingConfig())
    elif config_id.startswith("coarse"):
        cfg = make_coarse_cfg(TrainingConfig())
    else:
        raise ValueError(f"unknown config_id {config_id!r}")
    cfg = apply_overrides(dataclasses.replace(cfg, run_id=f"{config_id}-run"), overrides)
    if cfg.resume_run_id:
        saved = Path(cfg.run_dir) / cfg.resume_run_id / "config.json"
        cfg = dataclasses.replace(apply_overrides(load_config(saved), overrides),
                                  resume_run_id=cfg.resume_run_id)
    return update_cfg_debug(cfg) if debug else cfg


def synthetic_mesh_db(cfg: TrainingConfig, device: str = "cuda") -> BatchedMeshes:
    """The procedural cube and sphere of `synthetic=1`, with the config's
    mesh-database settings."""
    objects = RigidObjectDataset([
        RigidObject(label="cube", mesh=make_cube(0.04)),
        RigidObject(label="sphere", mesh=make_uv_sphere(0.04)),
    ])
    return MeshDataBase.from_object_ds(
        objects, max_faces=cfg.max_faces, n_points=cfg.n_points_mesh, n_sym=cfg.n_sym,
    ).batched(device=device)


def dataset_mesh_db(cfg: TrainingConfig, object_dataset: str, data_dir: str | None,
                    device: str = "cuda") -> BatchedMeshes:
    """The objects of `object_dataset` (the first `n_max_objects` if set),
    with the config's mesh-database settings."""
    objects = make_object_dataset(object_dataset, data_dir=data_dir)
    if cfg.n_max_objects:
        objects = objects.filter_objects(set(objects.labels[: cfg.n_max_objects]))
    return MeshDataBase.from_object_ds(
        objects, max_faces=cfg.max_faces, n_points=cfg.n_points_mesh, n_sym=cfg.n_sym,
    ).batched(device=device)


def dataset_loader(cfg: TrainingConfig, labels: list[str], data_dir: str | None,
                   device: str = "cuda") -> ParallelBatchLoader:
    """The batch loader of `cfg.train_datasets`, pinned for a CUDA device."""
    factory = PoseBatchFactory(
        dataset_names=tuple(cfg.train_datasets), labels=tuple(labels), batch_size=cfg.batch_size,
        resize=tuple(cfg.input_resize), input_depth=cfg.input_depth, min_area=cfg.min_area, data_dir=data_dir,
    )
    return ParallelBatchLoader(factory, n_workers=cfg.n_dataloader_workers, seed=cfg.seed,
                               pin_memory=str(device).startswith("cuda"))


def main(argv: list[str] | None = None) -> TrainState:
    argv = list(sys.argv[1:] if argv is None else argv)
    meta, rest = dict(META), []
    for a in argv:
        key, _, value = a.partition("=")
        if key in meta:
            meta[key] = value
        else:
            rest.append(a)
    cfg = make_config(meta["config_id"], meta["debug"] == "1", rest)
    logger.info("device: %s; config: %s", meta["device"], cfg)
    if meta["synthetic"] != "1":
        if not cfg.train_datasets:
            raise ValueError("set train_datasets=... or synthetic=1")
        data_dir = meta["data_dir"] or None
        mesh_db = dataset_mesh_db(cfg, meta["object_dataset"] or cfg.train_datasets[0], data_dir, meta["device"])
        loader = dataset_loader(cfg, mesh_db.labels, data_dir, meta["device"])
        try:
            return train(cfg, mesh_db, batches=loader, val_batches=None, log_fn=lambda log: logger.info("%s", log))
        finally:
            loader.close()

    mesh_db = synthetic_mesh_db(cfg, meta["device"])
    synth = synthetic_batch_fn(mesh_db, cfg.batch_size, tuple(cfg.input_resize), device=meta["device"])
    return train(
        cfg, mesh_db,
        batches=lambda step: synth(step_generator(cfg.seed, BATCH_STREAM, step)),
        val_batches=lambda epoch, i: synth(step_generator(cfg.seed, VAL_BATCH_STREAM, (epoch << 8) + i)),
        log_fn=lambda log: logger.info("%s", log),
    )


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
