"""Training curves from run directories' `log.txt` files.

Counterpart of `megapose6d_tpu/utils/plot_logs.py`: `load_logs` reads the
JSON lines per epoch (`training/train.py`) exactly as the JAX package
does; `plot_logs` draws one panel per metric, one line per run, in numpy
(the card's machine has no matplotlib) and writes a PNG.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..visualization.plotter import GLYPH_H, draw_text
from .png import write_png

PANEL_H, PANEL_W, MARGIN = 240, 320, 24
COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189), (140, 86, 75))


def load_logs(run_dirs: list[str | Path]) -> dict[str, list[dict]]:
    """`{run directory name: [one dict per log line]}` for the runs that
    have a `log.txt`."""
    logs = {}
    for rd in run_dirs:
        rd = Path(rd)
        path = rd / "log.txt"
        if path.exists():
            logs[rd.name] = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    return logs


def _line(img: np.ndarray, p0, p1, color) -> None:
    """A 1-pixel line from p0 to p1 ((x, y) floats), clipped."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.rint(np.linspace(p0[0], p1[0], n + 1)).astype(int)
    ys = np.rint(np.linspace(p0[1], p1[1], n + 1)).astype(int)
    keep = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[keep], xs[keep]] = color


def plot_logs(run_dirs: list[str | Path], metrics=("loss_total", "grad_norm"),
              out_path: str | Path | None = None) -> np.ndarray:
    """One panel per metric (its name on top, epochs left to right, the
    runs' values scaled to the panel), one coloured polyline per run, side
    by side on white; returns the `uint8` image and writes it as PNG to
    `out_path` when given."""
    logs = load_logs(run_dirs)
    img = np.full((PANEL_H, PANEL_W * len(metrics), 3), 255, np.uint8)
    for m, metric in enumerate(metrics):
        x0, x1 = m * PANEL_W + MARGIN, (m + 1) * PANEL_W - MARGIN // 2
        y0, y1 = MARGIN, PANEL_H - MARGIN
        draw_text(img, x0, (MARGIN - GLYPH_H) // 2, metric, color=(0, 0, 0))
        for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
            _line(img, a, b, (128, 128, 128))
        series = [([r["epoch"] for r in rows if metric in r], [r[metric] for r in rows if metric in r])
                  for rows in logs.values()]
        xs_all = [x for xs, _ in series for x in xs]
        ys_all = [y for _, ys in series for y in ys if np.isfinite(y)]
        if not xs_all or not ys_all:
            continue
        ex0, ex1 = min(xs_all), max(xs_all)
        ey0, ey1 = min(ys_all), max(ys_all)
        sx = lambda x: x0 + (x - ex0) / max(ex1 - ex0, 1e-12) * (x1 - x0)  # noqa: E731
        sy = lambda y: y1 - (y - ey0) / max(ey1 - ey0, 1e-12) * (y1 - y0)  # noqa: E731
        for k, (xs, ys) in enumerate(series):
            pts = [(sx(x), sy(y)) for x, y in zip(xs, ys) if np.isfinite(y)]
            color = COLORS[k % len(COLORS)]
            for a, b in zip(pts, pts[1:]):
                _line(img, a, b, color)
            for p in pts:
                _line(img, p, p, color)
    if out_path:
        write_png(out_path, img)
    return img
