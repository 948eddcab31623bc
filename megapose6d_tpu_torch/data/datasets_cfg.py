"""Datasets by name: the BOP branch of `megapose6d_tpu/data/datasets_cfg.py`.

`make_scene_dataset` and `make_object_dataset` resolve `<name>.bop19` for a
BOP-layout tree with `obj_NNNNNN` labels and the `test` split (such as the
synthetic `synthdemo.bop19`), under `data_dir` or
`MEGAPOSE_DATA_DIR/bop_datasets`. The BOP challenge datasets (their own
splits and label formats), the other BOP splits and the webdataset,
ModelNet, GSO and ShapeNet names are not ported yet and raise.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .. import config
from .bop_scene_dataset import BOPDataset, load_bop_object_dataset

_NOT_PORTED = ("webdataset.", "modelnet.", "gso.", "shapenet.")
_BOP_CHALLENGE = ("lm", "lmo", "tless", "tudl", "icbin", "itodd", "hb", "ycbv", "ruapc", "hope", "tyol")


def _bop_name(name: str, kind: str) -> str:
    """The directory name of `<name>.bop19`; raises for what is not ported."""
    ds_name, _, variant = name.partition(".")
    if name.startswith(_NOT_PORTED) or ds_name in _BOP_CHALLENGE:
        raise NotImplementedError(f"not ported yet: {kind} dataset {name}")
    if variant != "bop19":
        raise ValueError(f"unknown {kind} dataset: {name}")
    return ds_name


def keep_bop19(ds: BOPDataset) -> BOPDataset:
    """Restrict the frame index to the BOP19 targets
    (`test_targets_bop19.json`), in frame-index order."""
    targets = json.loads((ds.ds_dir / "test_targets_bop19.json").read_text())
    wanted = {(f"{int(t['scene_id']):06d}", int(t["im_id"])) for t in targets}
    fi = ds.frame_index
    keep = np.asarray([(s, int(v)) in wanted for s, v in zip(fi.scene_id, fi.view_id)], bool)
    if keep.sum() != len(wanted):
        raise ValueError(f"{int(keep.sum())} of {len(wanted)} BOP19 targets found")
    ds.frame_index = fi.take(np.nonzero(keep)[0])
    return ds


def make_scene_dataset(name: str, load_depth: bool = False, data_dir: str | Path | None = None,
                       n_frames: int | None = None) -> BOPDataset:
    """A BOP scene dataset by name (the first `n_frames` frames if given)."""
    ds_dir = Path(data_dir or config.BOP_DS_DIR) / _bop_name(name, "scene")
    ds = BOPDataset(ds_dir, split="test", load_depth=load_depth)
    if (ds.ds_dir / "test_targets_bop19.json").exists():
        ds = keep_bop19(ds)
    if n_frames is not None:
        ds.frame_index = ds.frame_index.take(np.arange(min(n_frames, len(ds))))
    return ds


def make_object_dataset(name: str, data_dir: str | Path | None = None):
    """The objects (`<ds>/models`) of a BOP scene dataset by name."""
    models_dir = Path(data_dir or config.BOP_DS_DIR) / _bop_name(name, "object") / "models"
    if not models_dir.exists():
        raise ValueError(f"unknown object dataset: {name} (no {models_dir})")
    return load_bop_object_dataset(models_dir)
