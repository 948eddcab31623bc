"""Profiling helpers: a `torch.profiler` chrome trace and named regions.

Counterpart of `megapose6d_tpu/utils/profiling.py` (`jax.profiler` there).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path, name: str = "trace.json"):
    """Trace the host and, where there is a card, the device, and write a
    chrome trace (chrome://tracing, Perfetto) to `log_dir/name`:

        with profiling.trace("build/trace") as prof:
            estimator.run_inference_pipeline(obs, detections)

    Yields the `torch.profiler.profile`, whose `key_averages()` tabulate
    the same events."""
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / name))


def annotate(name: str):
    """A named region inside a trace (a context manager, or a decorator)."""
    return torch.profiler.record_function(name)
