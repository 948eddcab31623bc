"""ResNet backbones with GroupNorm, NHWC at the interface.

Counterpart of `megapose6d_tpu/models/backbones.py` (`BasicBlock`,
`ResNet`). Parameters are float32; the forward pass computes in
`compute_dtype` (bfloat16 for the committed runs) and normalizes in
float32, as flax's GroupNorm does. Two details follow flax and differ from
torch's defaults: GroupNorm eps is 1e-6, and the spatial head flattens the
feature map in NHWC order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
GN_EPS = 1e-6


class GroupNorm(nn.Module):
    """GroupNorm computed in float32, returned in the input's dtype."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: Tensor) -> Tensor:
        y = F.group_norm(x.float(), self.groups, self.weight, self.bias, GN_EPS)
        return y.to(x.dtype)


class Conv(nn.Module):
    """Bias-free conv whose float32 kernel is cast to the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x: Tensor) -> Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class BasicBlock(nn.Module):
    """torchvision-style BasicBlock (2x 3x3 conv + skip)."""

    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 32):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, 1)
        self.norm1 = GroupNorm(groups, features)
        self.conv2 = Conv(features, features, 3, 1, 1)
        self.norm2 = GroupNorm(groups, features)
        self.downsample = None
        if cin != features or stride != 1:
            self.downsample = nn.Sequential(Conv(cin, features, 1, stride), GroupNorm(groups, features))

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-18/34 trunk + feature head; `[B, H, W, C]` -> `[B, n_features]`
    float32.

    `pool="spatial"` keeps the spatial arrangement (1x1 conv to
    `spatial_ch`, GroupNorm, flatten, Dense); `"avg"` pools globally."""

    def __init__(
        self,
        in_channels: int,
        input_hw: tuple[int, int],
        stage_sizes=(3, 4, 6, 3),
        width: int = 64,
        n_features: int = 512,
        norm_groups: int = 32,
        compute_dtype: torch.dtype = torch.float32,
        pool: str = "avg",
        spatial_ch: int = 64,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.pool = pool
        self.stem = Conv(in_channels, width, 7, 2, 3)
        self.stem_norm = GroupNorm(norm_groups, width)
        blocks, cin = [], width
        for i, n_blocks in enumerate(stage_sizes):
            features = width * 2**i
            for b in range(n_blocks):
                blocks.append(BasicBlock(cin, features, 2 if (i > 0 and b == 0) else 1, norm_groups))
                cin = features
        self.blocks = nn.Sequential(*blocks)
        if pool == "spatial":
            self.head_conv = Conv(cin, spatial_ch, 1)
            self.head_norm = GroupNorm(min(8, spatial_ch), spatial_ch)
            h, w = input_hw
            for _ in range(5):  # stem, max pool and three strided stages
                h, w = -(-h // 2), -(-w // 2)
            cin = h * w * spatial_ch
        elif pool != "avg":
            raise ValueError(f"unknown pool: {pool}")
        self.fc = nn.Linear(cin, n_features)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = F.relu(self.stem_norm(self.stem(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.blocks(x)
        if self.pool == "spatial":
            x = F.relu(self.head_norm(self.head_conv(x)))
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        else:
            x = x.mean(dim=(2, 3))
        x = F.linear(x, self.fc.weight.to(dt), self.fc.bias.to(dt))
        return x.float()


_BACKBONES = {
    "resnet18": ((2, 2, 2, 2), "avg"),
    "resnet34": ((3, 4, 6, 3), "avg"),
    "resnet18-spatial": ((2, 2, 2, 2), "spatial"),
    "resnet34-spatial": ((3, 4, 6, 3), "spatial"),
}


def make_backbone(
    name: str,
    in_channels: int,
    input_hw: tuple[int, int],
    n_features: int = 512,
    compute_dtype: torch.dtype = torch.float32,
) -> ResNet:
    """Backbone registry (the GroupNorm ResNets of the JAX package; the
    wide and zoo variants wait)."""
    if name not in _BACKBONES:
        raise NotImplementedError(f"backbone {name!r} is not ported")
    stages, pool = _BACKBONES[name]
    return ResNet(
        in_channels, input_hw, stages, n_features=n_features,
        compute_dtype=compute_dtype, pool=pool,
    )
