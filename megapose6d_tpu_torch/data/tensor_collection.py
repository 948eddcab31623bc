"""A batch of rows: per-row infos plus tensors sharing the leading dim.

Pandas-free counterpart of `PandasTensorCollection` and `concatenate` in
`megapose6d_tpu/data/tensor_collection.py`. `infos` is an ordered dict of
numpy columns (the DataFrame's columns, `label` first); the tensors are
reachable as attributes. Detections are infos `label, score, batch_im_id,
instance_id` + `bboxes [D, 4]`; pose estimates add `pose_score` and
`pose_logit` columns to those infos and carry `poses [D, 4, 4]`.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch


class TensorCollection:
    """Infos columns + same-length tensors, reachable as attributes.

    `TensorCollection(labels, **tensors)` makes a collection whose only
    column is `label`; `TensorCollection(infos={...}, **tensors)` one with
    the given columns (which include `label`)."""

    def __init__(
        self,
        labels: Sequence[str] | None = None,
        *,
        infos: Mapping[str, Sequence] | None = None,
        **tensors: torch.Tensor,
    ):
        cols = {} if labels is None else {"label": labels}
        cols.update(infos or {})
        if "label" not in cols:
            raise ValueError("a collection needs a label column")
        self.infos: dict[str, np.ndarray] = {k: np.asarray(v) for k, v in cols.items()}
        self.infos["label"] = self.infos["label"].astype(object)
        n = len(self.infos["label"])
        for name, col in self.infos.items():
            if len(col) != n:
                raise ValueError(f"info column {name} has {len(col)} rows, labels have {n}")
        self.tensors: dict[str, torch.Tensor] = {}
        for name, t in tensors.items():
            if len(t) != n:
                raise ValueError(f"{name} has {len(t)} rows, labels have {n}")
            self.tensors[name] = t

    @property
    def labels(self) -> list[str]:
        return [str(x) for x in self.infos["label"]]

    def __getattr__(self, name: str) -> torch.Tensor:
        tensors = self.__dict__.get("tensors", {})
        if name in tensors:
            return tensors[name]
        raise AttributeError(name)

    def __len__(self) -> int:
        return len(self.infos["label"])

    def __getitem__(self, ids) -> "TensorCollection":
        ids = np.asarray(torch.as_tensor(ids).cpu())
        if ids.dtype == bool:
            ids = np.nonzero(ids)[0]
        ids = ids.astype(np.int64).reshape(-1)
        t_ids = torch.as_tensor(ids)
        return TensorCollection(
            infos={k: v[ids] for k, v in self.infos.items()},
            **{k: v[t_ids.to(v.device)] for k, v in self.tensors.items()},
        )


def concatenate(collections: Sequence[TensorCollection]) -> TensorCollection:
    """Row-concatenate collections that have the same columns and tensors."""
    if not collections:
        raise ValueError("nothing to concatenate")
    first = collections[0]
    for c in collections[1:]:
        if list(c.infos) != list(first.infos) or list(c.tensors) != list(first.tensors):
            raise ValueError("collections have different columns or tensors")
    return TensorCollection(
        infos={k: np.concatenate([c.infos[k] for c in collections]) for k in first.infos},
        **{k: torch.cat([c.tensors[k] for c in collections]) for k in first.tensors},
    )
