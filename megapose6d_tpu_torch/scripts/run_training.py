"""Training CLI: a `config_id` preset and `key=value` overrides.

Counterpart of `megapose6d_tpu/scripts/run_training.py`, on one device
(`device=`, `cuda` by default) or data parallel under torchrun: each rank
trains on its own card on `batch_size / W` samples a step (its rows of
every synthetic global batch, or its own loader's batch), and the
data-parallel size W is, as in the JAX package, the largest world size
that divides `batch_size` (ranks beyond it idle). `synthetic=1` trains on scenes of a
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
    torchrun --nproc_per_node=N -m megapose6d_tpu_torch.scripts.run_training config_id=refiner \\
        synthetic=1 n_epochs=2

writes `<run_dir>/<run_id>/{config.json,log.txt,checkpoints/}`.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from pathlib import Path

import torch.distributed as dist

from ..data.datasets_cfg import make_object_dataset
from ..data.loader import WORKER_SEED_STRIDE, ParallelBatchLoader, PoseBatchFactory
from ..meshes.io import make_cube, make_uv_sphere
from ..meshes.mesh_db import BatchedMeshes, MeshDataBase, RigidObject, RigidObjectDataset
from ..parallel.distributed import init_distributed_mode, local_device
from ..training.config import (
    TrainingConfig,
    apply_overrides,
    load_config,
    make_coarse_cfg,
    make_refiner_cfg,
    update_cfg_debug,
)
from ..training.forward_loss import draws_to
from ..training.train import (
    BATCH_STREAM,
    VAL_BATCH_STREAM,
    TrainState,
    rank_rows,
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
                   device: str = "cuda", rank: int = 0, world: int = 1) -> ParallelBatchLoader:
    """The batch loader of `cfg.train_datasets`, pinned for a CUDA device:
    rank `rank`'s of `world` data-parallel ranks, `batch_size / world`
    samples a batch, seeded past the seeds of the lower ranks' workers (rank
    0's stream is the one-process run's)."""
    factory = PoseBatchFactory(
        dataset_names=tuple(cfg.train_datasets), labels=tuple(labels), batch_size=cfg.batch_size // world,
        resize=tuple(cfg.input_resize), input_depth=cfg.input_depth, min_area=cfg.min_area, data_dir=data_dir,
    )
    seed = cfg.seed + WORKER_SEED_STRIDE * (cfg.n_dataloader_workers + 1) * rank
    return ParallelBatchLoader(factory, n_workers=cfg.n_dataloader_workers, seed=seed,
                               pin_memory=str(device).startswith("cuda"))


def data_parallel_size(batch_size: int, world: int) -> int:
    """The largest world size not above `world` that divides `batch_size`."""
    n = world
    while batch_size % n:
        n -= 1
    return n


def main(argv: list[str] | None = None) -> TrainState | None:
    """Train; under torchrun every rank calls this, and the ranks beyond
    the data-parallel size return None without training."""
    argv = list(sys.argv[1:] if argv is None else argv)
    meta, rest = dict(META), []
    for a in argv:
        key, _, value = a.partition("=")
        if key in meta:
            meta[key] = value
        else:
            rest.append(a)
    cfg = make_config(meta["config_id"], meta["debug"] == "1", rest)
    device = meta["device"]
    rank, world = init_distributed_mode()
    n_dp, group = data_parallel_size(cfg.batch_size, world), None
    if world > 1:
        group = dist.new_group(list(range(n_dp))) if n_dp < world else dist.group.WORLD
        if device.startswith("cuda"):
            device = str(local_device())
        if rank >= n_dp:
            logger.info("rank %d idles: batch_size %d splits over %d of %d ranks", rank, cfg.batch_size, n_dp, world)
            return None
    logger.info("rank %d of %d data-parallel ranks; device: %s; config: %s", rank, n_dp, device, cfg)
    reduce_over = group if n_dp > 1 else None
    log_fn = lambda log: logger.info("%s", log)  # noqa: E731
    if meta["synthetic"] != "1":
        if not cfg.train_datasets:
            raise ValueError("set train_datasets=... or synthetic=1")
        data_dir = meta["data_dir"] or None
        mesh_db = dataset_mesh_db(cfg, meta["object_dataset"] or cfg.train_datasets[0], data_dir, device)
        loader = dataset_loader(cfg, mesh_db.labels, data_dir, device, rank, n_dp)
        try:
            return train(cfg, mesh_db, batches=loader, val_batches=None, log_fn=log_fn, reduce_over=reduce_over)
        finally:
            loader.close()

    mesh_db = synthetic_mesh_db(cfg, device)
    synth = synthetic_batch_fn(mesh_db, cfg.batch_size, tuple(cfg.input_resize), device=device)

    def rows(stream: int, index: int):
        """This rank's rows of the global batch `index` of `stream`."""
        return synth.make(draws_to(rank_rows(synth.draw(step_generator(cfg.seed, stream, index)), rank, n_dp),
                                   synth.device))

    return train(
        cfg, mesh_db,
        batches=lambda step: rows(BATCH_STREAM, step),
        val_batches=lambda epoch, i: rows(VAL_BATCH_STREAM, (epoch << 8) + i),
        log_fn=log_fn, reduce_over=reduce_over,
    )


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
