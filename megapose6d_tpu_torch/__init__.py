"""PyTorch + CUDA port of `megapose6d_tpu` for NVIDIA Hopper GPUs.

Module names mirror the JAX package, so `megapose6d_tpu_torch/ops/se3.py`
is the counterpart of `megapose6d_tpu/ops/se3.py`. This package imports
torch, numpy and scipy only; it never imports JAX or `megapose6d_tpu`.
Entry points place their tensors on `cuda` unless the caller passes
`device="cpu"`.
"""
