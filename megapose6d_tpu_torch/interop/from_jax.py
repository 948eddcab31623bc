"""Carry the JAX package's PosePredictor and detector params and run configs across.

`state_dict_from_jax` takes the flax variables as a nested dict of numpy
arrays (the caller reads the checkpoint; this module needs neither JAX nor
orbax) and returns the port's `state_dict`:
  - conv kernels HWIO -> OIHW,
  - Dense kernels `[in, out]` -> `[out, in]`,
  - GroupNorm and BatchNorm scale/bias -> weight/bias,
  - BatchNorm `batch_stats` mean/var -> running_mean/running_var,
  - conv biases as they are,
  - ConvTranspose kernels HWIO -> `[in, out, kh, kw]`, flipped in both
    spatial axes (flax correlates the dilated input with the kernel, torch
    with the flipped one).
`detector_state_dict_from_jax` does the same for `CenterNetDetector`.
`config_from_run_json` reads `runs/*/config.json` into a
`PosePredictorConfig`, as `TrainingConfig.model_config_kwargs` does in
the JAX package, plus the mesh database settings of the run.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..models.pose_predictor import PosePredictorConfig


def _conv(p: Mapping[str, Any]) -> np.ndarray:
    return np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))


def _norm(prefix: str, p: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(p["scale"]), f"{prefix}.bias": np.asarray(p["bias"])}


def _dense(prefix: str, p: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(p["kernel"]).T, f"{prefix}.bias": np.asarray(p["bias"])}


def _batch_norm(prefix: str, p: Mapping[str, Any], stats: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {**_norm(prefix, p), f"{prefix}.running_mean": np.asarray(stats["mean"]),
            f"{prefix}.running_var": np.asarray(stats["var"])}


def _wide(p: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """flax `WideResNet` params -> `backbones.WideResNet` keys. In a block,
    flax numbers the convs in creation order: the shortcut's first where
    there is one."""
    sd = {"stem.weight": _conv(p["Conv_0"])}
    n_blocks = sum(1 for k in p if k.startswith("WideResNetBlock_"))
    for i in range(n_blocks):
        b, pre = p[f"WideResNetBlock_{i}"], f"blocks.{i}"
        convs = [b[f"Conv_{j}"] for j in range(3) if f"Conv_{j}" in b]
        if len(convs) == 3:
            sd[f"{pre}.shortcut.weight"] = _conv(convs.pop(0))
        sd[f"{pre}.conv1.weight"] = _conv(convs[0])
        sd[f"{pre}.conv2.weight"] = _conv(convs[1])
        sd.update(_norm(f"{pre}.norm1", b["GroupNorm_0"]))
        sd.update(_norm(f"{pre}.norm2", b["GroupNorm_1"]))
    sd.update(_norm("norm", p["GroupNorm_0"]))
    sd.update(_dense("fc", p["Dense_0"]))
    return sd


def _zoo(p: Mapping[str, Any], stats: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """flax `ZooWideResNet` params and batch_stats -> `backbones.ZooWideResNet`
    keys."""
    sd = {"stem.weight": _conv(p["conv1"]), **_batch_norm("stem_bn", p["bn1"], stats["bn1"])}
    names = sorted((k for k in p if k.startswith("layer")),
                   key=lambda k: tuple(int(x) for x in k[len("layer"):].split("_")))
    for i, name in enumerate(names):
        b, s, pre = p[name], stats[name], f"blocks.{i}"
        sd[f"{pre}.conv1.weight"] = _conv(b["conv1"])
        sd[f"{pre}.conv2.weight"] = _conv(b["conv2"])
        sd.update(_batch_norm(f"{pre}.bn1", b["bn1"], s["bn1"]))
        sd.update(_batch_norm(f"{pre}.bn2", b["bn2"], s["bn2"]))
        if "downsample" in b:
            sd[f"{pre}.downsample.weight"] = _conv(b["downsample"])
    return sd


def _backbone(p: Mapping[str, Any], stats: Mapping[str, Any] | None) -> dict[str, np.ndarray]:
    """flax backbone params (and batch_stats) -> the port's backbone keys
    (prefix `backbone.`)."""
    if "WideResNetBlock_0" in p:
        return {f"backbone.{k}": v for k, v in _wide(p).items()}
    if "layer1_0" in p:
        if stats is None:
            raise ValueError("a zoo backbone needs its batch_stats")
        return {f"backbone.{k}": v for k, v in _zoo(p, stats).items()}
    sd = {"stem.weight": _conv(p["Conv_0"]), **_norm("stem_norm", p["GroupNorm_0"]), **_basic_blocks(p)}
    if "Conv_1" in p:  # spatial head
        sd["head_conv.weight"] = _conv(p["Conv_1"])
        sd.update(_norm("head_norm", p["GroupNorm_1"]))
    sd.update(_dense("fc", p["Dense_0"]))
    return {f"backbone.{k}": v for k, v in sd.items()}


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax `PosePredictor` variables (`{"params": ..., "batch_stats": ...}`,
    or the params alone) -> the port's `PosePredictor.state_dict()`."""
    stats = params.get("batch_stats", {}).get("backbone")
    if "params" in params:
        params = params["params"]
    sd = _backbone(params["backbone"], stats)
    if "pose_fc" in params:
        sd.update(_dense("pose_fc", params["pose_fc"]))
    if "views_logits_fc" in params:
        sd.update(_dense("views_logits_fc", params["views_logits_fc"]))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _basic_blocks(p: Mapping[str, Any], prefix: str = "blocks") -> dict[str, np.ndarray]:
    sd = {}
    n_blocks = sum(1 for k in p if k.startswith("BasicBlock_"))
    for i in range(n_blocks):
        b, pre = p[f"BasicBlock_{i}"], f"{prefix}.{i}"
        sd[f"{pre}.conv1.weight"] = _conv(b["Conv_0"])
        sd.update(_norm(f"{pre}.norm1", b["GroupNorm_0"]))
        sd[f"{pre}.conv2.weight"] = _conv(b["Conv_1"])
        sd.update(_norm(f"{pre}.norm2", b["GroupNorm_1"]))
        if "Conv_2" in b:
            sd[f"{pre}.downsample.0.weight"] = _conv(b["Conv_2"])
            sd.update(_norm(f"{pre}.downsample.1", b["GroupNorm_2"]))
    return sd


def detector_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax `CenterNetDetector` variables (`{"params": ...}` or the params
    alone) -> the port's `CenterNetDetector.state_dict()`. flax numbers the
    module's own convs in creation order: the stem, then the heat, wh,
    offset and seg heads."""
    p = params.get("params", params)
    sd = {"stem.weight": _conv(p["Conv_0"]), **_norm("stem_norm", p["GroupNorm_0"]), **_basic_blocks(p)}
    n_up = sum(1 for k in p if k.startswith("ConvTranspose_"))
    for i in range(n_up):
        t = p[f"ConvTranspose_{i}"]
        sd[f"up.{2 * i}.weight"] = np.transpose(np.asarray(t["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1]
        sd[f"up.{2 * i}.bias"] = np.asarray(t["bias"])
        sd.update(_norm(f"up.{2 * i + 1}", p[f"GroupNorm_{i + 1}"]))
    for j, head in enumerate(("heat", "wh", "offset", "seg"), start=1):
        if f"Conv_{j}" in p:
            sd[f"{head}.weight"] = _conv(p[f"Conv_{j}"])
            sd[f"{head}.bias"] = np.asarray(p[f"Conv_{j}"]["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def config_from_run_json(path: str | Path) -> tuple[PosePredictorConfig, dict[str, int]]:
    """`runs/<run>/config.json` -> (model config, mesh DB settings
    `{"max_faces", "n_points_mesh", "n_sym"}`). A `multiview_type` without
    the `TCO+` prefix gains it (`front_1view` -> `TCO+front_1view`)."""
    d = json.loads(Path(path).read_text())
    mv = d["multiview_type"]
    if not mv.startswith("TCO+") and not mv.startswith("sphere"):
        mv = f"TCO+{mv}"
    cfg = PosePredictorConfig(
        backbone=d["backbone_str"],
        render_size=tuple(d["render_size"]),
        n_rendered_views=d["n_rendered_views"],
        multiview_type=mv,
        views_inplane_rotations=d["views_inplane_rotations"],
        remove_TCO_rendering=d["remove_TCO_rendering"],
        render_normals=d["render_normals"],
        render_depth=d["render_depth"],
        predict_pose_update=d["predict_pose_update"],
        predict_rendered_views_logits=d["predict_rendered_views_logits"],
        input_depth=d["input_depth"],
        depth_normalization_type=d.get("depth_normalization_type", "none"),
        compute_dtype=d["compute_dtype"],
        tile_hyp_pack=d.get("tile_hyp_pack", 1),
        **{k: d[k] for k in ("renderer", "face_chunk", "tile_face_chunk") if k in d},
    )
    db = {k: int(d[k]) for k in ("max_faces", "n_points_mesh", "n_sym")}
    return cfg, db
