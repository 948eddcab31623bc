"""Datasets by name.

Counterpart of `megapose6d_tpu/data/datasets_cfg.py`, with the same names:
the BOP19 challenge splits with their label formats, the other BOP splits,
the `.pbr` training sets, the generic `<name>`, `<name>.test` and
`<name>.train_real` trees (and `<name>.bop19` of an unregistered tree,
such as the synthetic `synthdemo.bop19`) with `obj_NNNNNN` labels,
ModelNet scenes and objects, GSO and ShapeNet objects with their
`nobjects=` / `filters=` modifiers, `dir:` mesh directories and
webdataset shards. BOP trees live under `data_dir` or
`MEGAPOSE_DATA_DIR/bop_datasets`, the others under `data_dir` or
`MEGAPOSE_DATA_DIR`. `*.panda3d` object names alias the plain ones.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .. import config
from .bop_scene_dataset import BOPDataset, load_bop_object_dataset
from .modelnet import DeepImModelNetDataset
from .object_datasets import (
    make_directory_object_dataset,
    make_gso_object_dataset,
    make_modelnet_object_dataset,
    make_shapenet_object_dataset,
)
from .web_scene_dataset import WebSceneDataset

BOP_DATASET_NAMES = ("lm", "lmo", "tless", "tudl", "icbin", "itodd", "hb", "ycbv", "ruapc", "hope", "tyol")

# (split, label format) of each BOP dataset's `.bop19` name; hb and tless
# test on their primesense split, lmo shares lm's labels.
_BOP19 = {
    "hb": ("test_primesense", "hb-{label}"),
    "icbin": ("test", "icbin-{label}"),
    "itodd": ("test", "itodd-{label}"),
    "lmo": ("test", "lm-{label}"),
    "tless": ("test_primesense", "tless-{label}"),
    "tudl": ("test", "tudl-{label}"),
    "ycbv": ("test", "ycbv-{label}"),
    "ruapc": ("test", "ruapc-{label}"),
    "hope": ("test", "hope-{label}"),
    "tyol": ("test", "tyol-{label}"),
    "lm": ("test", "lm-{label}"),
}

# The other BOP splits: name -> (directory, split, label format).
_BOP_EXTRA_SPLITS = {
    "tless.primesense.train": ("tless", "train_primesense", "tless-{label}"),
    "tless.primesense.test": ("tless", "test_primesense", "tless-{label}"),
    "ycbv.train.real": ("ycbv", "train_real", "ycbv-{label}"),
    "ycbv.train.synt": ("ycbv", "train_synt", "ycbv-{label}"),
    "ycbv.test": ("ycbv", "test", "ycbv-{label}"),
    "lmo.test": ("lmo", "test", "lm-{label}"),
    "hb.val": ("hb", "val_primesense", "hb-{label}"),
    "itodd.val": ("itodd", "val", "itodd-{label}"),
    "tudl.train.real": ("tudl", "train_real", "tudl-{label}"),
}

_PBR_DATASETS = ("hb", "icbin", "itodd", "lm", "tless", "tudl", "ycbv")

# DeepIM's ModelNet categories evaluated on 30 objects instead of 50.
_MODELNET_30 = {"bathtub", "bookshelf", "guitar", "range_hood", "sofa", "wardrobe", "tv_stand"}

# ShapeNet categories that ModelNet also has (the `remove_modelnet` filter).
SHAPENET_MODELNET_CATEGORIES = {
    "airplane", "bathtub", "bench", "bookshelf", "bottle", "bowl", "car", "chair", "guitar", "lamp", "laptop",
    "piano", "sofa", "table",
}


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
                       n_frames: int | None = None):
    """A scene dataset by name (the first `n_frames` frames if given)."""
    ds = None
    if name.startswith("webdataset."):
        ds = WebSceneDataset(Path(data_dir or config.WDS_DS_DIR) / name.split(".", 1)[1], load_depth=load_depth)
    elif name.startswith("modelnet."):
        _, category, split = name.split(".")
        ds = DeepImModelNetDataset(Path(data_dir or config.LOCAL_DATA_DIR) / "modelnet40", category=category,
                                   split=split, n_objects=30 if category in _MODELNET_30 else 50,
                                   load_depth=load_depth)
    else:
        bop_dir = Path(data_dir or config.BOP_DS_DIR)
        ds_name, _, variant = name.partition(".")
        if variant == "bop19":
            # An unregistered tree gets the test split and obj_NNNNNN labels.
            split, fmt = _BOP19.get(ds_name, ("test", "obj_{label}"))
            ds = BOPDataset(bop_dir / ds_name, split=split, label_format=fmt, load_depth=load_depth)
            if (ds.ds_dir / "test_targets_bop19.json").exists():
                ds = keep_bop19(ds)
        elif name in _BOP_EXTRA_SPLITS:
            dirname, split, fmt = _BOP_EXTRA_SPLITS[name]
            ds = BOPDataset(bop_dir / dirname, split=split, label_format=fmt, load_depth=load_depth)
        elif variant == "pbr" and ds_name in _PBR_DATASETS:
            ds = BOPDataset(bop_dir / ds_name, split="train_pbr", label_format=f"{ds_name}-{{label}}",
                            load_depth=load_depth)
        elif variant in ("", "test", "train_real"):
            ds = BOPDataset(bop_dir / ds_name, split=variant if variant else "test", load_depth=load_depth)
    if ds is None:
        raise ValueError(f"unknown scene dataset: {name}")
    if n_frames is not None:
        ds.frame_index = ds.frame_index.take(np.arange(min(n_frames, len(ds.frame_index))))
    return ds


def _bop_object_ds(bop_dir: Path, dirname: str, models: str, fmt: str):
    models_dir = bop_dir / dirname / models
    if not models_dir.exists():
        raise FileNotFoundError(models_dir)
    return load_bop_object_dataset(models_dir, label_format=fmt)


def _gso(root: Path, rest: str):
    """`gso.[nobjects=N.]<split>`: `N` objects drawn by
    `RandomState(0).choice` from the labels, as the JAX package draws them."""
    n_objects = None
    if rest.startswith("nobjects="):
        head, _, rest = rest.partition(".")
        n_objects = int(head.split("=")[1])
    split = rest if rest and rest != "panda3d" else "orig"
    ds = make_gso_object_dataset(root / "gso" / f"models_{split}")
    if n_objects is not None:
        keep = np.random.RandomState(0).choice([o.label for o in ds.objects], n_objects, replace=False)
        ds = ds.filter_objects(set(keep.tolist()))
    return ds


def _shapenet(root: Path, rest: str):
    """`shapenet.[filters=a,b.]<split>`: `remove_modelnet` drops the
    categories ModelNet has; any other filter keeps the labels listed in
    `shapenetcorev2/stats/shapenet_<filter>.json`."""
    filters: list[str] = []
    if rest.startswith("filters="):
        head, _, rest = rest.partition(".")
        filters = head.split("=")[1].split(",")
    shapenet_dir = root / "shapenetcorev2" / f"models_{rest or 'orig'}"
    if not shapenet_dir.exists():
        shapenet_dir = root / "shapenetcorev2"
    ds = make_shapenet_object_dataset(shapenet_dir)
    for f in filters:
        if f == "remove_modelnet":
            keep = {o.label for o in ds.objects if not any(c in o.label for c in SHAPENET_MODELNET_CATEGORIES)}
        else:
            keep = set(json.loads((root / "shapenetcorev2" / "stats" / f"shapenet_{f}.json").read_text()))
        ds = ds.filter_objects(keep)
    return ds


def make_object_dataset(name: str, data_dir: str | Path | None = None):
    """An object dataset by name."""
    bop_dir = Path(data_dir or config.BOP_DS_DIR)
    root = Path(data_dir or config.LOCAL_DATA_DIR)
    base = name[: -len(".panda3d")] if name.endswith(".panda3d") else name
    tless = {"tless.cad": "models_cad", "tless.eval": "models_eval", "tless.reconst": "models_reconst"}
    if base in tless:
        return _bop_object_ds(bop_dir, "tless", tless[base], "tless-{label}")
    if base in ("lm", "lmo"):
        return _bop_object_ds(bop_dir, "lm", "models", "lm-{label}")
    if base in BOP_DATASET_NAMES:
        return _bop_object_ds(bop_dir, base, "models", f"{base}-{{label}}")
    if name.startswith("gso."):
        return _gso(root, name[len("gso."):])
    if name.startswith("shapenet."):
        return _shapenet(root, name[len("shapenet."):])
    if name.startswith("modelnet."):
        category, split = name.split(".")[1:3]
        return make_modelnet_object_dataset(root / "modelnet40", category=category, split=split,
                                            n_objects=30 if category in _MODELNET_30 else 50)
    if name.startswith("dir:"):
        return make_directory_object_dataset(name[len("dir:"):])
    # An unregistered BOP-layout tree: <bop_dir>/<name>/models, obj_NNNNNN labels.
    generic = bop_dir / name.split(".")[0] / "models"
    if generic.exists():
        return load_bop_object_dataset(generic)
    raise ValueError(f"unknown object dataset: {name}")


def make_urdf_dataset(name: str, data_dir: str | Path | None = None):
    """The meshes of `<data_dir or LOCAL_DATA_DIR>/urdfs/<name>`, as a flat
    mesh directory."""
    root = (Path(data_dir) if data_dir else config.LOCAL_DATA_DIR) / "urdfs"
    return make_directory_object_dataset(root / name)


def get_obj_ds_info(ds_name: str) -> tuple[str, str]:
    """(object dataset, URDF dataset) names of a scene dataset name."""
    ds = ds_name.split(".")[0]
    if ds == "tless":
        return "tless.cad", "tless.cad"
    if ds in BOP_DATASET_NAMES:
        return ds, ds
    if ds == "modelnet":
        parts = ds_name.split(".")
        return f"modelnet.{parts[1]}.{parts[2]}", ds_name
    raise ValueError(ds_name)
