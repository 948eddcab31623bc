"""BOP-format dataset writer.

Counterpart of `megapose6d_tpu/data/bop_writer.py`: the BOP directory
layout (`scene_camera.json`, `scene_gt.json`, `scene_gt_info.json`, `rgb/`,
`depth/`, `mask_visib/`, and `models/` with `models_info.json` and PLYs in
millimetres), so that the synthetic generator's output feeds the BOP
reader, the runners and the meters. The same JSON as the JAX writer; the
PNGs are written by the port's encoder (`utils/png.py`) and decode to the
same arrays as PIL's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from ..evaluation.bop import label_to_obj_id
from ..meshes.io import TriMesh, save_ply
from ..utils.png import write_png
from .scene_dataset import SceneObservation


def bop_label(obj_id: int) -> str:
    """Canonical BOP object label ('obj_000014')."""
    return f"obj_{obj_id:06d}"


def write_bop_models(meshes: Iterable[tuple[int, TriMesh]], models_dir: str | Path) -> Path:
    """`models/obj_XXXXXX.ply` in millimetres and `models_info.json`
    (diameter and bounding box in mm) from `(obj_id, mesh in metres)`."""
    models_dir = Path(models_dir)
    models_dir.mkdir(parents=True, exist_ok=True)
    infos = {}
    for obj_id, mesh in meshes:
        mm = mesh.scaled(1000.0)
        save_ply(mm, models_dir / f"obj_{obj_id:06d}.ply")
        v = mm.vertices
        infos[str(obj_id)] = {
            "diameter": mm.diameter(),
            **{f"min_{a}": float(v[:, i].min()) for i, a in enumerate("xyz")},
            **{f"size_{a}": float(v[:, i].max() - v[:, i].min()) for i, a in enumerate("xyz")},
        }
    (models_dir / "models_info.json").write_text(json.dumps(infos, indent=1))
    return models_dir


def write_scene_ds_as_bop(observations: Iterator[SceneObservation], ds_dir: str | Path, split: str = "test") -> Path:
    """Observations as `<ds_dir>/<split>/<scene>/...` BOP scenes: poses
    camera <- model (`TWO` with the world at the camera), depth as uint16
    millimetres (depth_scale 1), visible masks from the segmentation."""
    base = Path(ds_dir) / split
    scenes: dict[str, dict[str, dict]] = {}
    for obs in observations:
        scene = f"{int(obs.infos.scene_id):06d}"
        view = int(obs.infos.view_id)
        scene_dir = base / scene
        (scene_dir / "rgb").mkdir(parents=True, exist_ok=True)
        ann = scenes.setdefault(scene, {"scene_camera": {}, "scene_gt": {}, "scene_gt_info": {}})
        write_png(scene_dir / "rgb" / f"{view:06d}.png", obs.rgb)
        if obs.depth is not None:
            (scene_dir / "depth").mkdir(exist_ok=True)
            write_png(scene_dir / "depth" / f"{view:06d}.png",
                      np.clip(obs.depth * 1000.0, 0, 65535).astype(np.uint16))
        K = np.asarray(obs.camera_data.K, np.float64)
        ann["scene_camera"][str(view)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
        gt_rows, info_rows = [], []
        for n, obj in enumerate(obs.object_datas):
            TCO = np.asarray(obj.TWO, np.float64)
            gt_rows.append({"obj_id": label_to_obj_id(obj.label), "cam_R_m2c": TCO[:3, :3].reshape(-1).tolist(),
                            "cam_t_m2c": (TCO[:3, 3] * 1000.0).tolist()})
            if obs.segmentation is not None:
                mask = (obs.segmentation == obj.unique_id).astype(np.uint8)
                (scene_dir / "mask_visib").mkdir(exist_ok=True)
                write_png(scene_dir / "mask_visib" / f"{view:06d}_{n:06d}.png", mask * 255)
                px = int(mask.sum())
                ys, xs = np.nonzero(mask)
                bbox = ([int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]
                        if px else [0, 0, 0, 0])
            else:
                px, b = 0, obj.bbox_modal
                bbox = [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])] if b is not None else [0, 0, 0, 0]
            info_rows.append({"bbox_obj": bbox, "bbox_visib": bbox, "px_count_visib": px, "px_count_all": px,
                              "px_count_valid": px,
                              "visib_fract": float(obj.visib_fract if obj.visib_fract is not None else 1.0)})
        ann["scene_gt"][str(view)] = gt_rows
        ann["scene_gt_info"][str(view)] = info_rows
    for scene, ann in scenes.items():
        for name, payload in ann.items():
            (base / scene / f"{name}.json").write_text(json.dumps(payload))
    return base
