"""A batch of rows: per-row labels plus tensors sharing the leading dim.

Pandas-free counterpart of `megapose6d_tpu/data/tensor_collection.py`:
detections are labels + `bboxes [D, 4]` (+ optional `scores [D]`); pose
estimates are labels + `poses [D, 4, 4]` + scores and logits.
"""

from __future__ import annotations

from typing import Sequence

import torch


class TensorCollection:
    """Labels + same-length tensors, reachable as attributes."""

    def __init__(self, labels: Sequence[str], **tensors: torch.Tensor):
        self.labels = list(labels)
        self.tensors: dict[str, torch.Tensor] = {}
        for name, t in tensors.items():
            if len(t) != len(self.labels):
                raise ValueError(f"{name} has {len(t)} rows, labels have {len(self.labels)}")
            self.tensors[name] = t

    def __getattr__(self, name: str) -> torch.Tensor:
        tensors = self.__dict__.get("tensors", {})
        if name in tensors:
            return tensors[name]
        raise AttributeError(name)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, ids) -> "TensorCollection":
        ids = torch.as_tensor(ids)
        if ids.dtype == torch.bool:
            ids = ids.nonzero()[:, 0]
        ids = ids.long()
        return TensorCollection(
            [self.labels[i] for i in ids.tolist()],
            **{k: v[ids.to(v.device)] for k, v in self.tensors.items()},
        )
