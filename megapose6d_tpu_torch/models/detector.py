"""Object detector: an anchor-free heatmap network and its inference wrapper.

Counterpart of `megapose6d_tpu/models/detector.py`: a CenterNet-style
detector (per-class centre heatmap, box size and centre offset, and with
`predict_masks` a per-class segmentation, all at stride 4 on a GroupNorm
ResNet trunk), its peak decoding, its training losses, and `Detector`,
the reference's filtering contract (score threshold, one instance per
class, labels, per-instance masks). NHWC at the interface, as in the JAX
package; convolutions run NCHW on cuDNN. Details that follow flax: the
transposed convolutions (`nn.ConvTranspose`, 4x4, stride 2, "SAME", the
kernel not flipped) are `conv_transpose2d` with padding 1 and the kernel
flipped; `top_k` ties go to the lower flat index (a stable sort).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.tensor_collection import TensorCollection
from ..ops.cropping import resize_bilinear
from .backbones import BasicBlock, Conv, GroupNorm
from .pose_predictor import _lecun_normal_

Tensor = torch.Tensor
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    n_classes: int = 1
    width: int = 32
    stride: int = 4  # output stride of the heatmap
    max_detections: int = 32
    compute_dtype: str = "float32"
    predict_masks: bool = False  # a per-class segmentation head


class BiasConv(nn.Module):
    """3x3 conv with bias (padding 1); float32 parameters cast to the
    input's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: Tensor) -> Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), 1, 1)


class UpConv(nn.Module):
    """flax's `ConvTranspose(cout, (4, 4), strides=(2, 2))` with bias:
    the dilated input padded by 2 and correlated with the kernel, which is
    torch's transposed convolution (padding 1) with the kernel flipped.
    `weight [cin, cout, 4, 4]` is torch's layout (already flipped)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: Tensor) -> Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=2, padding=1)


class CenterNetDetector(nn.Module):
    """ResNet-lite trunk -> `heatmap [B, h, w, C]` logits, `wh [B, h, w, 2]`
    (softplus box sizes in heatmap cells), `offset [B, h, w, 2]` and, with
    `predict_masks`, `seg [B, h, w, C]` logits; `h, w` = the input's over
    the stride. Images `[B, H, W, 3]` in [0, 1]."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.stem = Conv(3, w, 7, 2, 3)
        self.stem_norm = GroupNorm(8, w)
        self.blocks = nn.Sequential(BasicBlock(w, w, 2, 8), BasicBlock(w, 2 * w, 2, 8),
                                    BasicBlock(2 * w, 4 * w, 2, 8))
        n_up = {4: 2, 8: 1, 16: 0}[cfg.stride]
        cin, ups = 4 * w, []
        for _ in range(n_up):
            ups += [UpConv(cin, 2 * w), GroupNorm(8, 2 * w)]
            cin = 2 * w
        self.up = nn.ModuleList(ups)
        self.heat = BiasConv(cin, cfg.n_classes)
        self.wh = BiasConv(cin, 2)
        self.offset = BiasConv(cin, 2)
        self.seg = BiasConv(cin, cfg.n_classes) if cfg.predict_masks else None

    def init_weights(self, generator: torch.Generator) -> "CenterNetDetector":
        """flax's initializers: lecun-normal kernels, zero biases, unit
        GroupNorm scales."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Conv, BiasConv)):
                    _lecun_normal_(m.weight, m.weight[0].numel(), 1.0, generator)
                elif isinstance(m, UpConv):
                    _lecun_normal_(m.weight, m.weight.shape[0] * 16, 1.0, generator)
                if isinstance(m, (BiasConv, UpConv, GroupNorm)):
                    nn.init.zeros_(m.bias)
                if isinstance(m, GroupNorm):
                    nn.init.ones_(m.weight)
        return self

    def forward(self, images: Tensor) -> dict[str, Tensor]:
        x = images.to(_DTYPES[self.cfg.compute_dtype]).permute(0, 3, 1, 2)
        x = F.relu(self.stem_norm(self.stem(x)))
        x = self.blocks(x)
        for i in range(0, len(self.up), 2):
            x = F.relu(self.up[i + 1](self.up[i](x)))
        nhwc = lambda t: t.float().permute(0, 2, 3, 1)
        wh = nhwc(self.wh(x))
        out = {"heatmap": nhwc(self.heat(x)), "wh": torch.logaddexp(wh, torch.zeros_like(wh)),
               "offset": nhwc(self.offset(x))}
        if self.seg is not None:
            out["seg"] = nhwc(self.seg(x))
        return out


def decode_detections(outputs: dict[str, Tensor], stride: int, top_k: int) -> dict[str, Tensor]:
    """Peak suppression (a cell equal to its 3x3 max-pool) and the top-K
    peaks over cells and classes (ties to the lower flat index). Returns
    `boxes [B, K, 4]` xyxy in input pixels, `scores [B, K]`, `classes [B, K]`
    int32."""
    heat = torch.sigmoid(outputs["heatmap"])  # [B, h, w, C]
    B, h, w, C = heat.shape
    pooled = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
    peaks = torch.where(heat == pooled, heat, 0.0).reshape(B, h * w * C)
    scores, idx = torch.sort(peaks, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]
    cls = (idx % C).to(torch.int32)
    pix = idx // C
    ys, xs = (pix // w).float(), (pix % w).float()
    take = lambda m: m.reshape(B, h * w, 2).gather(1, pix[..., None].expand(B, pix.shape[1], 2))
    off, wh = take(outputs["offset"]), take(outputs["wh"])
    cx, cy = (xs + off[..., 0]) * stride, (ys + off[..., 1]) * stride
    bw, bh = wh[..., 0] * stride, wh[..., 1] * stride
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    return {"boxes": boxes, "scores": scores, "classes": cls}


def detection_loss(outputs: dict[str, Tensor], gt_boxes: Tensor, gt_classes: Tensor, gt_valid: Tensor,
                   stride: int, focal_alpha: float = 2.0, focal_beta: float = 4.0
                   ) -> tuple[Tensor, dict[str, Tensor]]:
    """CenterNet's focal heatmap loss (a Gaussian target splatted at each
    box's integer centre cell, the max over instances) plus L1 size and
    offset losses at the centres. `gt_boxes [B, N, 4]` xyxy, `gt_classes
    [B, N]`, `gt_valid [B, N]`."""
    heat = outputs["heatmap"]
    B, h, w, C = heat.shape
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2 / stride
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2 / stride
    bw = (gt_boxes[..., 2] - gt_boxes[..., 0]) / stride
    bh = (gt_boxes[..., 3] - gt_boxes[..., 1]) / stride
    ix = cx.to(torch.int32).clamp(0, w - 1)
    iy = cy.to(torch.int32).clamp(0, h - 1)
    dev = heat.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    sigma = (torch.sqrt(bw * bh) / 3.0).clamp_min(1.0)  # [B, N]
    d2 = (ys - iy.float()[..., None, None]) ** 2 + (xs - ix.float()[..., None, None]) ** 2
    g = torch.exp(-d2 / (2 * sigma[..., None, None] ** 2))  # [B, N, h, w]
    g = torch.where(gt_valid[..., None, None], g, 0.0)
    onehot = (gt_classes.long()[..., None] == torch.arange(C, device=dev)).float()  # [B, N, C]
    target = (g[..., None] * onehot[:, :, None, None, :]).amax(1)  # [B, h, w, C]

    p = torch.sigmoid(heat)
    pos = (target > 0.999).float()
    pos_loss = -pos * (1 - p) ** focal_alpha * torch.log(p.clamp_min(1e-6))
    neg_loss = -(1 - pos) * (1 - target) ** focal_beta * p**focal_alpha * torch.log((1 - p).clamp_min(1e-6))
    heat_loss = (pos_loss.sum() + neg_loss.sum()) / pos.sum().clamp_min(1.0)

    pix = (iy * w + ix).long()
    at_centers = lambda m: m.reshape(B, h * w, 2).gather(1, pix[..., None].expand(*pix.shape, 2))
    vw = gt_valid.float()[..., None]
    n_valid = vw.sum().clamp_min(1.0)
    wh_loss = ((at_centers(outputs["wh"]) - torch.stack([bw, bh], -1)).abs() * vw).sum() / n_valid
    off_gt = torch.stack([cx - ix, cy - iy], -1)
    off_loss = ((at_centers(outputs["offset"]) - off_gt).abs() * vw).sum() / n_valid
    loss = heat_loss + 0.1 * wh_loss + off_loss
    return loss, {"det_heat_loss": heat_loss, "det_wh_loss": wh_loss, "det_off_loss": off_loss}


def segmentation_loss(outputs: dict[str, Tensor], gt_seg: Tensor, stride: int) -> Tensor:
    """Per-class binary cross-entropy of the seg head against the class map
    `gt_seg [B, H, W]` (-1 background) sampled at the head's stride, both
    cropped to their common extent."""
    seg = outputs["seg"]  # [B, h, w, C]
    _, h, w, C = seg.shape
    tgt = gt_seg[:, ::stride, ::stride]
    mh, mw = min(h, tgt.shape[1]), min(w, tgt.shape[2])
    seg, tgt = seg[:, :mh, :mw], tgt[:, :mh, :mw]
    onehot = (tgt.long()[..., None] == torch.arange(C, device=seg.device)).float()  # background: all 0
    p = torch.sigmoid(seg)
    bce = -(onehot * torch.log(p.clamp_min(1e-6)) + (1 - onehot) * torch.log((1 - p).clamp_min(1e-6)))
    return bce.mean()


class Detector:
    """Detections of one observation: the model's top `max_detections`
    peaks at or above `detection_th`, optionally (per call) one per class
    (the highest), with per-instance masks (the class's segmentation, upsampled
    to the image, above 0.5 and inside the box) when the model predicts
    masks. Runs on the model's device."""

    def __init__(self, model: CenterNetDetector, labels, detection_th: float = 0.7):
        self.model = model.eval()
        self.labels = list(labels)
        self.detection_th = detection_th

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def infer(self, images: Tensor) -> dict[str, Tensor]:
        """Decoded detections of `images [B, H, W, 3]`, and with masks the
        class probabilities upsampled to the images, `seg [B, H, W, C]`.
        cuDNN runs its deterministic algorithms here, so that two calls on
        one image give the same bits (its transposed convolutions may
        otherwise sum in another order from call to call)."""
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True, allow_tf32=cudnn.allow_tf32):
            raw = self.model(images)
        cfg = self.model.cfg
        out = decode_detections(raw, cfg.stride, cfg.max_detections)
        if cfg.predict_masks:
            out["seg"] = resize_bilinear(torch.sigmoid(raw["seg"]), tuple(images.shape[1:3]))
        return out

    def get_detections(self, observation, detection_th: float | None = None,
                       one_instance_per_class: bool = False) -> TensorCollection:
        th = self.detection_th if detection_th is None else detection_th
        out = self.infer(observation.images[..., :3].to(self.device, torch.float32))
        scores = out["scores"][0].cpu().numpy()
        classes = out["classes"][0].cpu().numpy()
        sel = np.nonzero(scores >= th)[0]
        if one_instance_per_class and len(sel):
            seen: set[int] = set()
            best = []
            for i in np.argsort(-scores[sel]):
                if int(classes[sel[i]]) not in seen:
                    seen.add(int(classes[sel[i]]))
                    best.append(sel[i])
            sel = np.asarray(best, np.int64)
        n = len(sel)
        idx = torch.as_tensor(sel, dtype=torch.long, device=self.device)
        boxes = out["boxes"][0][idx].float().reshape(n, 4)
        infos = {"label": [self.labels[int(c)] for c in classes[sel]], "score": scores[sel],
                 "batch_im_id": np.zeros(n, np.int64), "instance_id": np.arange(n, dtype=np.int64)}
        tensors = {"bboxes": boxes}
        if "seg" in out:
            cls = torch.as_tensor(classes[sel].astype(np.int64), device=self.device)
            seg = out["seg"][0].permute(2, 0, 1)[cls]  # [n, H, W]
            H, W = seg.shape[1:]
            yy = torch.arange(H, device=seg.device)[:, None]
            xx = torch.arange(W, device=seg.device)[None, :]
            x0, y0, x1, y1 = (boxes[:, i, None, None] for i in range(4))
            tensors["masks"] = (seg > 0.5) & (xx >= x0) & (xx <= x1) & (yy >= y0) & (yy <= y1)
        return TensorCollection(infos=infos, **tensors)
