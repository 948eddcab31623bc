"""Timers: a pausable wall clock, and a device timer on CUDA events.

Counterpart of `megapose6d_tpu/utils/timers.py`, whose `DeviceTimer`
fences with `block_until_ready`; here it records a CUDA event before and
after the timed work and reads the time between them on the device.
"""

from __future__ import annotations

import time

import torch


class Timer:
    """Pausable wall-clock timer."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.elapsed = 0.0
        self._start = None
        return self

    def start(self):
        self._start = time.monotonic()
        return self

    def pause(self):
        if self._start is not None:
            self.elapsed += time.monotonic() - self._start
            self._start = None
        return self

    def resume(self):
        return self.start()

    def stop(self) -> float:
        self.pause()
        return self.elapsed


class DeviceTimer:
    """Device time of the work queued on the current CUDA stream between
    `start()` and `end()`, from two CUDA events; `elapsed()` in seconds.
    Disabled, it records nothing and reads 0. Enabled without a card it
    raises."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.elapsed_ = 0.0
        self._events = None

    def start(self):
        if self.enabled:
            if not torch.cuda.is_available():
                raise RuntimeError("DeviceTimer: no CUDA card to time on")
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def end(self, *outputs) -> float:
        """Record the end event, wait for it, and return the seconds.
        `outputs` are accepted for the JAX package's signature; the event
        orders after them on the stream already."""
        del outputs
        if self.enabled and self._events is not None:
            self._events[1].record()
            self._events[1].synchronize()
            self.elapsed_ = self._events[0].elapsed_time(self._events[1]) / 1000.0
        return self.elapsed_

    def elapsed(self) -> float:
        return self.elapsed_
