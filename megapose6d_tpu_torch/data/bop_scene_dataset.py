"""BOP-format dataset reader.

Counterpart of `megapose6d_tpu/data/bop_scene_dataset.py`: reads the BOP
directory layout (scene_camera.json, scene_gt.json, scene_gt_info.json,
rgb/, depth/, mask_visib/), converts mm to m, and yields
`SceneObservation`s with ground-truth poses and visible/full boxes.
Images are decoded by `native.decode_image`: libpng and libjpeg where the
native library builds, else the port's PNG reader (`utils/png.py`) and JPEG
decoder (`native/jpeg.cc`), the same arrays. Labels follow `label_format`
(`obj_{label}` by default, `tless-{label}` and so on for the BOP
challenge datasets). The `train_pbr` splits keep their rgb as JPEG; ITODD
keeps grey TIFFs in `gray/` (`utils/tiff.py`), repeated to three channels.

See https://github.com/thodan/bop_toolkit/blob/master/docs/bop_datasets_format.md
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .. import native
from .scene_dataset import FrameIndex, ObservationInfos, SceneDataset, SceneObservation
from .types import CameraData, ObjectData


class BOPDataset(SceneDataset):
    def __init__(
        self,
        ds_dir: str | Path,
        label_format: str = "obj_{label}",
        split: str = "test",
        load_depth: bool = False,
        load_segmentation: bool = True,
    ):
        self.ds_dir = Path(ds_dir)
        if not self.ds_dir.exists():
            raise FileNotFoundError(f"missing dataset dir: {ds_dir}")
        self.split = split
        self.label_format = label_format
        self.base_dir = self.ds_dir / split

        scene_ids, view_ids = [], []
        self.annotations: dict[str, dict] = {}
        for scene_dir in sorted(self.base_dir.iterdir()):
            if not scene_dir.is_dir():
                continue
            ann = {}
            for f in ("scene_camera", "scene_gt_info", "scene_gt"):
                path = scene_dir / f"{f}.json"
                if path.exists():
                    ann[f] = json.loads(path.read_text())
            self.annotations[scene_dir.name] = ann
            for view_id in ann["scene_camera"]:
                scene_ids.append(scene_dir.name)
                view_ids.append(int(view_id))
        super().__init__(
            FrameIndex(np.asarray(scene_ids, dtype=object), np.asarray(view_ids, np.int64)),
            load_depth=load_depth, load_segmentation=load_segmentation,
        )

    def _load_scene_observation(self, infos: ObservationInfos) -> SceneObservation:
        scene_id, view_id = infos.scene_id, infos.view_id
        scene_dir = self.base_dir / scene_id
        ann = self.annotations[scene_id]
        cam_ann = ann["scene_camera"][str(view_id)]
        K = np.asarray(cam_ann["cam_K"], np.float64).reshape(3, 3)

        rgb_path = scene_dir / "rgb" / f"{view_id:06d}.png"
        if not rgb_path.exists():
            rgb_path = rgb_path.with_suffix(".jpg")
        if not rgb_path.exists():  # ITODD's grey TIFFs
            rgb_path = scene_dir / "gray" / f"{view_id:06d}.tif"
        rgb = _imread(rgb_path)
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[..., None], 3, axis=-1)
        rgb = rgb[..., :3]
        h, w = rgb.shape[:2]

        depth = None
        if self.load_depth:
            depth = _imread(scene_dir / "depth" / f"{view_id:06d}.png").astype(np.float32)
            depth *= float(cam_ann.get("depth_scale", 1.0)) / 1000.0  # -> m

        object_datas: list[ObjectData] = []
        segmentation = None
        if "scene_gt" in ann:
            gt = ann["scene_gt"][str(view_id)]
            gt_info = ann.get("scene_gt_info", {}).get(str(view_id))
            if self.load_segmentation:
                segmentation = np.zeros((h, w), np.uint32)
            for n, obj in enumerate(gt):
                TCO = np.eye(4)
                TCO[:3, :3] = np.asarray(obj["cam_R_m2c"], np.float64).reshape(3, 3)
                TCO[:3, 3] = np.asarray(obj["cam_t_m2c"], np.float64) / 1000.0  # mm -> m
                # BOP stores camera <- model; the world frame is the camera's.
                obj_data = ObjectData(label=_label(int(obj["obj_id"]), self.label_format), TWO=TCO, unique_id=n + 1)
                if gt_info is not None:
                    info_n = gt_info[n]
                    obj_data.bbox_modal = np.asarray(_xywh_to_xyxy(info_n["bbox_visib"]), np.float64)
                    obj_data.bbox_amodal = np.asarray(_xywh_to_xyxy(info_n["bbox_obj"]), np.float64)
                    obj_data.visib_fract = float(info_n.get("visib_fract", 1.0))
                if self.load_segmentation:
                    mask_path = scene_dir / "mask_visib" / f"{view_id:06d}_{n:06d}.png"
                    if mask_path.exists():
                        segmentation[_imread(mask_path) > 0] = n + 1
                object_datas.append(obj_data)

        return SceneObservation(
            rgb=rgb, depth=depth, segmentation=segmentation, infos=infos,
            object_datas=object_datas, camera_data=CameraData(K=K, resolution=(h, w)),
        )


def _imread(path: Path) -> np.ndarray:
    """A PNG, JPEG or TIFF file through `native.decode_image`."""
    return native.decode_image(Path(path).read_bytes())


def _label(obj_id: int, label_format: str = "obj_{label}") -> str:
    """`label_format` of the zero-padded id: `obj_NNNNNN` by default, as
    the PLY files are named."""
    return label_format.format(label=f"{obj_id:06d}")


def _xywh_to_xyxy(box: list) -> list:
    x, y, w, h = box
    return [x, y, x + w, y + h]


def load_bop_object_dataset(models_dir: str | Path, label_format: str = "obj_{label}"):
    """A `RigidObjectDataset` from a BOP `models/` directory: PLY meshes in
    mm and the symmetries of `models_info.json`, labelled by `label_format`."""
    from ..meshes.mesh_db import RigidObject, RigidObjectDataset
    from ..ops.symmetries import ContinuousSymmetry, DiscreteSymmetry

    models_dir = Path(models_dir)
    infos_path = models_dir / "models_info.json"
    infos = json.loads(infos_path.read_text()) if infos_path.exists() else {}
    objects = []
    for ply in sorted(models_dir.glob("*.ply")):
        obj_id = int(ply.stem.split("_")[-1])
        info = infos.get(str(obj_id), {})
        sym_d = [DiscreteSymmetry(np.asarray(m, np.float64).reshape(4, 4))
                 for m in info.get("symmetries_discrete", [])]
        sym_c = [ContinuousSymmetry(np.asarray(s["offset"], np.float64), np.asarray(s["axis"], np.float64))
                 for s in info.get("symmetries_continuous", [])]
        objects.append(RigidObject(
            label=_label(obj_id, label_format), mesh_path=ply, mesh_units="mm",
            symmetries_discrete=sym_d, symmetries_continuous=sym_c,
        ))
    return RigidObjectDataset(objects)
