"""Tar-shard scene dataset (the training-set format).

Counterpart of `megapose6d_tpu/data/web_scene_dataset.py`: tar shards of
frames, each frame a key with `rgb.png`, `segmentation.png`, `depth.png`,
`camera_data.json`, `object_datas.json` and `infos.json`, on the standard
library's `tarfile`; a writer, a random-access reader and an endless
shuffled iterator with a sample buffer. PNGs are written by the port's
codec (`utils/png.py`) and read by `native.decode_image` (libpng where the
native library builds, else `utils/png.py`; both give PIL's arrays).
"""

from __future__ import annotations

import io
import json
import random
import tarfile
from pathlib import Path
from typing import Iterator

import numpy as np

from ..native import decode_image
from ..utils.png import encode_png
from .scene_dataset import FrameIndex, ObservationInfos, SceneDataset, SceneObservation
from .types import CameraData, ObjectData

DEPTH_SCALE = 1000.0  # metres -> uint16 millimetres


def write_scene_ds_as_wds(
    observations: Iterator[SceneObservation],
    out_dir: str | Path,
    frames_per_shard: int = 1000,
    shard_offset: int = 0,
    frame_id_offset: int = 0,
) -> list[Path]:
    """Write `observations` into shards of `frames_per_shard` frames.
    `shard_offset` / `frame_id_offset` let several ranks write disjoint
    shard ranges of one dataset."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shards: list[Path] = []
    tar = None
    n_in_shard = 0
    frame_id = frame_id_offset

    def add(name: str, data: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    for obs in observations:
        if tar is None or n_in_shard >= frames_per_shard:
            if tar is not None:
                tar.close()
            path = out_dir / f"shard-{len(shards) + shard_offset:06d}.tar"
            shards.append(path)
            tar = tarfile.open(path, "w")
            n_in_shard = 0
        key = f"{frame_id:08d}"
        add(f"{key}.rgb.png", encode_png(obs.rgb))
        if obs.segmentation is not None:
            add(f"{key}.segmentation.png", encode_png(obs.segmentation.astype(np.uint16)))
        if obs.depth is not None:
            add(f"{key}.depth.png", encode_png(np.clip(obs.depth * DEPTH_SCALE, 0, 65535).astype(np.uint16)))
        add(f"{key}.object_datas.json", json.dumps([o.to_json() for o in obs.object_datas]).encode())
        add(f"{key}.camera_data.json", obs.camera_data.to_json().encode())
        add(f"{key}.infos.json", json.dumps({"scene_id": obs.infos.scene_id, "view_id": obs.infos.view_id}).encode())
        n_in_shard += 1
        frame_id += 1
    if tar is not None:
        tar.close()
    return shards


def _decode_sample(parts: dict[str, bytes], load_depth: bool) -> SceneObservation:
    rgb = decode_image(parts["rgb.png"])[..., :3]
    seg = decode_image(parts["segmentation.png"]).astype(np.uint32) if "segmentation.png" in parts else None
    depth = None
    if load_depth and "depth.png" in parts:
        depth = decode_image(parts["depth.png"]).astype(np.float32) / DEPTH_SCALE
    infos_d = json.loads(parts.get("infos.json", b"{}"))
    return SceneObservation(
        rgb=rgb, depth=depth, segmentation=seg,
        infos=ObservationInfos(scene_id=str(infos_d.get("scene_id", "")), view_id=int(infos_d.get("view_id", -1))),
        object_datas=[ObjectData.from_json(d) for d in json.loads(parts["object_datas.json"])],
        camera_data=CameraData.from_json(parts["camera_data.json"].decode()),
    )


class WebSceneDataset(SceneDataset):
    """Random-access reader over a directory of shards. The frame index
    names each frame by its shard (`scene_id`) and its position in the
    dataset (`view_id`)."""

    def __init__(self, wds_dir: str | Path, load_depth: bool = False):
        self.wds_dir = Path(wds_dir)
        self.shard_paths = sorted(self.wds_dir.glob("*.tar"))
        if not self.shard_paths:
            raise FileNotFoundError(f"no shards in {wds_dir}")
        self.index: list[tuple[int, str]] = []
        self._members: dict[tuple[int, str], list[str]] = {}
        for si, path in enumerate(self.shard_paths):
            with tarfile.open(path) as tar:
                keys: dict[str, list[str]] = {}
                for name in tar.getnames():
                    keys.setdefault(name.partition(".")[0], []).append(name)
            for key, names in keys.items():
                self.index.append((si, key))
                self._members[(si, key)] = names
        super().__init__(FrameIndex(np.asarray([str(s) for s, _ in self.index], dtype=object),
                                    np.arange(len(self.index), dtype=np.int64)), load_depth=load_depth)

    def __getitem__(self, idx: int) -> SceneObservation:
        si, key = self.index[idx]
        with tarfile.open(self.shard_paths[si]) as tar:
            parts = {name.partition(".")[2]: tar.extractfile(name).read() for name in self._members[(si, key)]}
        return _decode_sample(parts, self.load_depth)


class IterableWebSceneDataset:
    """Endless iterator over the shards in a shuffled order, each pass
    anew, through a shuffle buffer of `buffer_size` frames."""

    def __init__(self, web_ds: WebSceneDataset, buffer_size: int = 100, seed: int = 0):
        self.web_ds = web_ds
        self.buffer_size = buffer_size
        self.rng = random.Random(seed)

    def _iter_shard(self, path: Path) -> Iterator[SceneObservation]:
        with tarfile.open(path) as tar:
            parts: dict[str, bytes] = {}
            current_key: str | None = None
            for member in tar:
                key, _, suffix = member.name.partition(".")
                if current_key is not None and key != current_key:
                    yield _decode_sample(parts, self.web_ds.load_depth)
                    parts = {}
                current_key = key
                parts[suffix] = tar.extractfile(member).read()
            if parts:
                yield _decode_sample(parts, self.web_ds.load_depth)

    def __iter__(self) -> Iterator[SceneObservation]:
        buffer: list[SceneObservation] = []
        while True:
            shards = list(self.web_ds.shard_paths)
            self.rng.shuffle(shards)
            for shard in shards:
                for obs in self._iter_shard(shard):
                    buffer.append(obs)
                    if len(buffer) >= self.buffer_size:
                        idx = self.rng.randrange(len(buffer))
                        buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                        yield buffer.pop()
