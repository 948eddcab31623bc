"""ResNet backbones, NHWC at the interface.

Counterpart of `megapose6d_tpu/models/backbones.py`: the GroupNorm
`ResNet` (`BasicBlock`), the pre-activation `WideResNet`
(`WideResNetBlock`) and `ZooWideResNet` (`ZooBasicBlockV2`), the
reference checkpoints' BatchNorm backbone: `zoo_resnet*` normalizes with
the running statistics (carried across from flax's `batch_stats` or from
a reference checkpoint), `zoo_resnet*-train` with the batch's while the
module trains, updating the running ones as flax does. Parameters are float32; the forward pass
computes in `compute_dtype` (bfloat16 for the committed runs), which a
caller may override per call, and normalizes in float32. Details that
follow flax and differ from torch's defaults: GroupNorm eps is 1e-6,
BatchNorm eps 1e-5, and the spatial head flattens the feature map in NHWC
order.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
GN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.99  # flax's: running = 0.99 * running + 0.01 * batch


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


class _RankMean(torch.autograd.Function):
    """The mean over the ranks of `group` (all-reduce), whose gradient is
    the mean of the ranks' gradients (the sum of every rank's loss
    through it, over the ranks that average their gradients after)."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return _all_reduce_mean(x.clone(), group)

    @staticmethod
    def backward(ctx, grad: Tensor):
        return _all_reduce_mean(grad.contiguous().clone(), ctx.group), None


def _all_reduce_mean(x: Tensor, group) -> Tensor:
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


@contextlib.contextmanager
def synced_batch_stats(model: nn.Module, group):
    """Within the block, every `BatchNorm` of `model` that trains on batch
    statistics takes them over the ranks of `group` (a process group; None
    leaves each rank its own rows)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


class BatchNorm(nn.Module):
    """BatchNorm computed in float32 and returned in the input's dtype.

    With `batch_stats=True`, while the module trains, it normalizes with
    the batch's statistics and updates the running ones as flax's
    `BatchNorm(use_running_average=False)` does, not as torch's: the
    biased variance `E[x^2] - E[x]^2` (clipped at 0), and
    `running = 0.99 * running + 0.01 * batch`. Otherwise (and in eval
    mode) it normalizes with the running statistics. With a process
    group in `group` (`synced_batch_stats`), the batch is the ranks' rows
    together: `E[x]` and `E[x^2]` are averaged over the ranks, as flax's
    `BatchNorm(axis_name=...)` pmeans them (the ranks hold equal rows),
    and their gradients too, so the running statistics stay equal on
    every rank (the reference fine-tunes with SyncBN)."""

    def __init__(self, channels: int, batch_stats: bool = False):
        super().__init__()
        self.batch_stats = batch_stats
        self.group = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        if not (self.batch_stats and self.training):
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                             training=False, eps=BN_EPS)
            return y.to(x.dtype)
        mean, mean2 = torch.stack([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        if self.group is not None:
            mean, mean2 = _RankMean.apply(torch.stack([mean, mean2]), self.group)
        var = (mean2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
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

    def forward(self, x: Tensor, compute_dtype: torch.dtype | None = None) -> Tensor:
        dt = compute_dtype or self.compute_dtype
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


class WideResNetBlock(nn.Module):
    """Pre-activation wide block: GroupNorm, relu, 3x3 conv, GroupNorm,
    relu, 3x3 conv, plus the input (through a 1x1 conv of the activated
    input when the shape changes)."""

    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 16):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin)
        self.shortcut = Conv(cin, features, 1, stride) if cin != features or stride != 1 else None
        self.conv1 = Conv(cin, features, 3, stride, 1)
        self.norm2 = GroupNorm(groups, features)
        self.conv2 = Conv(features, features, 3, 1, 1)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.norm1(x))
        shortcut = x if self.shortcut is None else self.shortcut(y)
        y = F.relu(self.norm2(self.conv1(y)))
        return self.conv2(y) + shortcut


class WideResNet(nn.Module):
    """Pre-activation WideResNet-18/34 (widen factor 2): a 3x3 stem, four
    stages each starting at stride 2, GroupNorm, relu, global mean,
    Dense to `n_features`."""

    def __init__(
        self,
        in_channels: int,
        stage_sizes=(2, 2, 2, 2),
        width: int = 64,
        widen: int = 2,
        n_features: int = 512,
        norm_groups: int = 16,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = Conv(in_channels, width, 3, 1, 1)
        blocks, cin = [], width
        for i, n_blocks in enumerate(stage_sizes):
            features = width * widen * 2**i
            for b in range(n_blocks):
                blocks.append(WideResNetBlock(cin, features, 2 if b == 0 else 1, norm_groups))
                cin = features
        self.blocks = nn.Sequential(*blocks)
        self.norm = GroupNorm(norm_groups, cin)
        self.fc = nn.Linear(cin, n_features)

    def forward(self, x: Tensor, compute_dtype: torch.dtype | None = None) -> Tensor:
        dt = compute_dtype or self.compute_dtype
        x = self.blocks(self.stem(x.to(dt).permute(0, 3, 1, 2)))
        x = F.relu(self.norm(x)).mean(dim=(2, 3))
        return F.linear(x, self.fc.weight.to(dt), self.fc.bias.to(dt)).float()


class ZooBasicBlockV2(nn.Module):
    """Pre-activation block of the reference's checkpoints: BatchNorm,
    relu, 3x3 conv, BatchNorm, relu, 3x3 conv, plus the input (through a
    norm-free 1x1 conv of the activated input when the shape changes)."""

    def __init__(self, cin: int, features: int, stride: int = 1, batch_stats: bool = False):
        super().__init__()
        self.bn1 = BatchNorm(cin, batch_stats)
        self.downsample = Conv(cin, features, 1, stride) if cin != features or stride != 1 else None
        self.conv1 = Conv(cin, features, 3, stride, 1)
        self.bn2 = BatchNorm(features, batch_stats)
        self.conv2 = Conv(features, features, 3, 1, 1)

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(x))
        residual = x if self.downsample is None else self.downsample(out)
        out = F.relu(self.bn2(self.conv1(out)))
        return self.conv2(out) + residual


class ZooWideResNet(nn.Module):
    """The reference checkpoints' backbone: a 5x5/2 BatchNorm stem, max
    pool, four pre-activation stages, global mean; `[B, H, W, C]` ->
    `[B, 8 * width]` float32 (no Dense). `batch_stats=True` is the
    trainable form (`zoo_resnet*-train`, see `BatchNorm`)."""

    def __init__(
        self,
        in_channels: int,
        stage_sizes=(3, 4, 6, 3),
        width: int = 64,
        compute_dtype: torch.dtype = torch.float32,
        batch_stats: bool = False,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = Conv(in_channels, width, 5, 2, 2)
        self.stem_bn = BatchNorm(width, batch_stats)
        blocks, cin = [], width
        for i, n_blocks in enumerate(stage_sizes):
            features = width * 2**i
            for b in range(n_blocks):
                blocks.append(ZooBasicBlockV2(cin, features, 2 if (i > 0 and b == 0) else 1, batch_stats))
                cin = features
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: Tensor, compute_dtype: torch.dtype | None = None) -> Tensor:
        dt = compute_dtype or self.compute_dtype
        x = F.relu(self.stem_bn(self.stem(x.to(dt).permute(0, 3, 1, 2))))
        x = self.blocks(F.max_pool2d(x, 3, 2, 1))
        return x.mean(dim=(2, 3)).float()


_BACKBONES = {
    "resnet18": ((2, 2, 2, 2), "avg"),
    "resnet34": ((3, 4, 6, 3), "avg"),
    "resnet18-spatial": ((2, 2, 2, 2), "spatial"),
    "resnet34-spatial": ((3, 4, 6, 3), "spatial"),
    "wide_resnet18": ((2, 2, 2, 2), "wide"),
    "wide_resnet34": ((3, 4, 6, 3), "wide"),
    "zoo_resnet18": ((2, 2, 2, 2), "zoo"),
    "zoo_resnet34": ((3, 4, 6, 3), "zoo"),
    "zoo_resnet18-train": ((2, 2, 2, 2), "zoo-train"),
    "zoo_resnet34-train": ((3, 4, 6, 3), "zoo-train"),
}


def make_backbone(
    name: str,
    in_channels: int,
    input_hw: tuple[int, int],
    n_features: int = 512,
    compute_dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Backbone registry, the JAX package's names."""
    if name not in _BACKBONES:
        raise ValueError(f"unknown backbone: {name}")
    stages, kind = _BACKBONES[name]
    if kind == "wide":
        return WideResNet(in_channels, stages, n_features=n_features, compute_dtype=compute_dtype)
    if kind.startswith("zoo"):
        return ZooWideResNet(in_channels, stages, compute_dtype=compute_dtype, batch_stats=kind == "zoo-train")
    return ResNet(
        in_channels, input_hw, stages, n_features=n_features,
        compute_dtype=compute_dtype, pool=kind,
    )
