"""The reference MegaPose's torch checkpoints, read straight into the port.

Counterpart of `megapose6d_tpu/interop/torch_convert.py`, with no flax
step between: the released megapose-1.0 models are `PosePredictor`
state_dicts whose backbone is the pre-activation WideResNet
(`backbone_str=resnet34`), which the port builds as `zoo_resnet34`
(`models/backbones.py` `ZooWideResNet`). Both are torch, so the tensors
keep their layout and only the keys change:

  reference key                               port key
  backbone.conv1.weight                    -> backbone.stem.weight
  backbone.bn1.*                           -> backbone.stem_bn.*
  backbone.layerL.B.{bn1,conv1,bn2,conv2}  -> backbone.blocks.i.{...}
  backbone.layerL.B.downsample.weight      -> backbone.blocks.i.downsample.weight
  pose_fc.*                                -> pose_fc.*
  views_logits_head.*                      -> views_logits_fc.*

where i counts the blocks in (L, B) order, as `interop/from_jax.py`
numbers flax's `layerL_B`. BatchNorm's `num_batches_tracked` has no
counterpart and is dropped; any other key raises with the list. Old
checkpoints go through `change_keys_of_older_models` first.

The real checkpoint files are not in the repository; the mapping is held
against the JAX package's converter on a torch model built with the
reference's key names (`tests/test_torch_zoo_convert.py`).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^backbone\.layer(\d+)\.(\d+)\.(bn1|bn2|conv1|conv2|downsample)\.(.+)$")
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def change_keys_of_older_models(state_dict: Mapping[str, Any]) -> dict:
    """Key renames for pre-release checkpoints (the reference's
    `utils/models_compat.py`)."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("backbone.backbone"):
            k = "backbone." + k[len("backbone.backbone."):]
        elif k.startswith("backbone.head.0."):
            k = "views_logits_head." + k[len("backbone.head.0."):]
        out[k] = v
    return out


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(x, np.float32))


def pose_predictor_state_dict_from_reference(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A reference `PosePredictor` state_dict -> the port's
    `PosePredictor.state_dict()` keys for a `zoo_resnet34` (or
    `zoo_resnet18`) backbone whose heads match the checkpoint's config.
    Unknown keys raise."""
    sd = change_keys_of_older_models(dict(state_dict))
    blocks = sorted({(int(m.group(1)), int(m.group(2))) for m in map(_BLOCK.match, sd) if m})
    index = {lb: i for i, lb in enumerate(blocks)}
    out: dict[str, torch.Tensor] = {}
    unknown = []
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        m = _BLOCK.match(key)
        if m:
            mod, field = m.group(3), m.group(4)
            ok = field in _BN_FIELDS if mod.startswith("bn") else field == "weight"
            new = f"backbone.blocks.{index[int(m.group(1)), int(m.group(2))]}.{mod}.{field}"
        elif key == "backbone.conv1.weight":
            ok, new = True, "backbone.stem.weight"
        elif key.startswith("backbone.bn1."):
            ok, new = key[len("backbone.bn1."):] in _BN_FIELDS, "backbone.stem_bn." + key[len("backbone.bn1."):]
        elif key in ("pose_fc.weight", "pose_fc.bias"):
            ok, new = True, key
        elif key in ("views_logits_head.weight", "views_logits_head.bias"):
            ok, new = True, "views_logits_fc." + key.rsplit(".", 1)[1]
        else:
            ok = False
        if not ok:
            unknown.append(key)
            continue
        out[new] = _tensor(value)
    if unknown:
        raise ValueError(f"unconverted checkpoint keys ({len(unknown)}): {sorted(unknown)}")
    return out


def load_torch_pose_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """A reference `checkpoint.pth.tar` (`{"state_dict": ...}` or a bare
    state_dict) as the port's `PosePredictor` state_dict."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
    return pose_predictor_state_dict_from_reference(ckpt.get("state_dict", ckpt))
