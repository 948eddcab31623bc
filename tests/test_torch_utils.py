"""The port's utilities (`utils/timers.py`, `random.py`, `resources.py`,
`logging.py`, `profiling.py`, `plot_logs.py`) on the CPU.

- `Timer` pauses and resumes; `DeviceTimer` disabled reads 0, and enabled
  without a card raises (it times with CUDA events only; the card's run
  holds it against the host clock).
- `seed_everything` makes `random`, `np.random` and torch repeat their
  draws, and seeds the first two as the JAX package's does.
- `host_memory_rss_mb` reads this process's resident set; without a card
  `device_memory_stats` raises.
- `load_logs` equals the JAX package's on two run directories (one
  without a `log.txt`); `plot_logs` draws one panel per metric with a
  line per run and writes a PNG that decodes to it.
- `profiling.trace` writes a chrome trace holding an `annotate` region.
"""

import json
import logging
import random
import time

import numpy as np
import pytest
import torch

from megapose6d_tpu.utils import plot_logs as jpl
from megapose6d_tpu.utils import random as jrandom
from megapose6d_tpu_torch.utils import plot_logs, profiling, resources
from megapose6d_tpu_torch.utils import random as trandom
from megapose6d_tpu_torch.utils.logging import get_logger
from megapose6d_tpu_torch.utils.png import read_png
from megapose6d_tpu_torch.utils.timers import DeviceTimer, Timer


def test_timer_pause_resume():
    t = Timer().start()
    time.sleep(0.02)
    first = t.pause().elapsed
    time.sleep(0.03)  # paused: not counted
    assert t.elapsed == first and 0.015 < first < 0.5
    t.resume()
    time.sleep(0.02)
    total = t.stop()
    assert first + 0.015 < total < first + 0.5
    assert t.reset().elapsed == 0.0


def test_device_timer_needs_a_card(monkeypatch):
    off = DeviceTimer(enabled=False)
    off.start()
    assert off.end() == 0.0 and off.elapsed() == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DeviceTimer().start()


def test_seed_everything():
    def draws():
        return random.random(), float(np.random.rand()), float(torch.rand(()))

    assert trandom.seed_everything(123) == 123
    a = draws()
    trandom.seed_everything(123)
    assert draws() == a
    jrandom.seed_everything(123)
    assert (random.random(), float(np.random.rand())) == a[:2]
    assert 0 <= trandom.seed_everything() < 2**31


def test_resources(monkeypatch):
    assert resources.host_memory_rss_mb() > 10.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resources.device_memory_stats()


def test_logger_formats_elapsed(capsys):
    log = get_logger("megapose6d_tpu_torch.test_utils")
    assert get_logger("megapose6d_tpu_torch.test_utils") is log and len(log.handlers) == 1
    log.info("hello")
    err = capsys.readouterr().err
    assert "megapose6d_tpu_torch.test_utils INFO] hello" in err and err.startswith("[")
    assert log.level == logging.INFO


def write_runs(tmp_path):
    runs = []
    for i, losses in enumerate(([1.0, 0.6, 0.4], [0.9, 0.8, 0.5, 0.3])):
        rd = tmp_path / f"run{i}"
        rd.mkdir()
        (rd / "log.txt").write_text("".join(
            json.dumps({"epoch": e + 1, "loss_total": v, "grad_norm": 2 * v}) + "\n" for e, v in enumerate(losses))
            + "\n")
        runs.append(rd)
    (tmp_path / "empty").mkdir()
    return runs + [tmp_path / "empty"]


def test_load_logs_matches_jax(tmp_path):
    runs = write_runs(tmp_path)
    logs = plot_logs.load_logs(runs)
    assert logs == jpl.load_logs(runs)
    assert list(logs) == ["run0", "run1"] and len(logs["run1"]) == 4


def test_plot_logs_png(tmp_path):
    runs = write_runs(tmp_path)
    img = plot_logs.plot_logs(runs, metrics=("loss_total", "grad_norm"), out_path=tmp_path / "curves.png")
    assert img.shape == (plot_logs.PANEL_H, 2 * plot_logs.PANEL_W, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(read_png(tmp_path / "curves.png"), img)
    for color in plot_logs.COLORS[:2]:  # a line per run in each panel
        hit = (img == np.asarray(color, np.uint8)).all(-1)
        assert hit[:, : plot_logs.PANEL_W].sum() > 50 and hit[:, plot_logs.PANEL_W :].sum() > 50
    assert not (img == np.asarray(plot_logs.COLORS[2], np.uint8)).all(-1).any()


def test_profiling_trace_holds_the_region(tmp_path):
    with profiling.trace(tmp_path) as prof:
        with profiling.annotate("phase/matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "phase/matmul" in names and any(n and "mm" in n for n in names)
    assert any(e.key == "phase/matmul" for e in prof.key_averages())
