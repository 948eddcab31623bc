"""The batch loader of dataset-fed training.

Counterpart of `megapose6d_tpu/data/loader.py` in PyTorch's idiom: a
`torch.utils.data.DataLoader` (`batch_size=None`) over an
`IterableDataset` whose worker `i` runs `factory(seed + 1000003 (i + 1))`
after seeding `random` and `np.random` with that seed, as the JAX loader
seeds its processes. Each worker decodes, augments and collates whole
batches on the host; the main process takes them in turn, pinned when
`pin_memory` is set, for the trainer to copy to the card with
`non_blocking=True`. A worker never touches CUDA.

The workers come from a `forkserver` context: forked from a server
process that never initialised CUDA, they end with `os._exit`. (Spawned
workers on CUDA builds of torch abort in C++ static destructors at exit,
once they have read images: "terminate called without an active
exception", which the DataLoader reports as a dead worker.)

`n_workers=0` runs `factory(seed)` in the calling process, after seeding
`random` and `np.random` with `seed` (the JAX inline loader leaves them as
they are), so a run's stream is a function of its seed. A worker that dies
makes the next batch raise (the DataLoader's watchdog); `close()` stops
the workers and may be called again.
"""

from __future__ import annotations

import random
from typing import Callable, Iterator

import numpy as np
from torch.utils.data import DataLoader, IterableDataset, get_worker_info

from .pose_dataset import host_batch_to_torch


def seed_host_rngs(seed: int) -> None:
    """Seed the global `random` and `np.random`, which the augmentations draw from."""
    random.seed(seed)
    np.random.seed(seed % (2**32))


class _BatchStream(IterableDataset):
    """The batches of `factory(worker seed)`, as CPU tensors."""

    def __init__(self, factory: Callable[[int], Iterator], seed: int):
        self.factory = factory
        self.seed = seed

    def __iter__(self):
        info = get_worker_info()
        seed = self.seed if info is None else self.seed + 1000003 * (info.id + 1)
        seed_host_rngs(seed)
        for batch in self.factory(seed):
            yield host_batch_to_torch(batch)


class ParallelBatchLoader:
    """Endless batch iterator over `n_workers` worker processes.

    Args:
      factory: picklable `worker_seed -> Iterator[BatchPoseData]` (numpy).
      n_workers: worker processes; 0 runs the factory inline.
      seed: base seed; worker i gets `seed + 1000003 * (i + 1)`.
      pin_memory: pin each batch in page-locked memory (for CUDA copies).
    Each worker keeps two batches ahead (the DataLoader's default).
    """

    def __init__(self, factory: Callable[[int], Iterator], n_workers: int = 4, seed: int = 0,
                 pin_memory: bool = False):
        self.factory = factory
        self.n_workers = int(n_workers)
        self.seed = int(seed)
        self.pin_memory = pin_memory
        self._iter = None

    def start(self) -> "ParallelBatchLoader":
        if self._iter is None:
            kw = {}
            if self.n_workers > 0:
                # Build the native decoder here, so the workers load it
                # instead of each compiling it.
                from .. import native

                native.available()
                kw = dict(multiprocessing_context="forkserver")
            loader = DataLoader(_BatchStream(self.factory, self.seed), batch_size=None, num_workers=self.n_workers,
                                pin_memory=self.pin_memory, **kw)
            self._iter = iter(loader)
        return self

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return next(self.start()._iter)

    def close(self) -> None:
        """Stop the workers; a second call does nothing."""
        it, self._iter = self._iter, None
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()

    def __enter__(self) -> "ParallelBatchLoader":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PoseBatchFactory:
    """Picklable `worker_seed -> Iterator[BatchPoseData]` over named scene
    datasets: each worker opens its own readers (tar handles are not
    shared), then decodes, augments, samples and collates."""

    def __init__(self, dataset_names: tuple[str, ...], labels: tuple[str, ...], batch_size: int,
                 resize: tuple[int, int], input_depth: bool = False, min_area: float | None = None,
                 data_dir: str | None = None):
        self.dataset_names = tuple(dataset_names)
        self.labels = tuple(labels)
        self.batch_size = int(batch_size)
        self.resize = tuple(resize)
        self.input_depth = bool(input_depth)
        self.min_area = min_area
        self.data_dir = data_dir

    def __call__(self, worker_seed: int):
        from .datasets_cfg import make_scene_dataset
        from .pose_dataset import PoseDataset
        from .scene_dataset import IterableMultiSceneDataset, RandomIterableSceneDataset

        scene_iters = [
            RandomIterableSceneDataset(make_scene_dataset(n, load_depth=self.input_depth, data_dir=self.data_dir),
                                       seed=worker_seed)
            for n in self.dataset_names
        ]
        obs_iter = iter(IterableMultiSceneDataset(scene_iters, seed=worker_seed))
        pose_ds = PoseDataset(
            None, resize=self.resize, apply_depth_augmentation=self.input_depth, depth_supported=self.input_depth, min_area=self.min_area,
            keep_labels_set=set(self.labels),
        )
        return pose_ds.iter_batches(obs_iter, self.batch_size, {l: i for i, l in enumerate(self.labels)})

