"""Full-f32 arithmetic for pose geometry.

Counterpart of `megapose6d_tpu/ops/_precision.py`, which pins JAX's
contractions to `Precision.HIGHEST`. On the GPU the matching risk is TF32:
cuDNN runs f32 convolutions in TF32 by default, and matmuls can be switched
to it. Geometry needs sub-pixel accuracy, so both stay off.
"""

from __future__ import annotations

import torch


def pin_f32() -> None:
    """Turn TF32 off for f32 matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
