"""Slim a run directory for keeping: only the latest checkpoint, saved
again without Adam's state.

Counterpart of `megapose6d_tpu/scripts/slim_run_dir.py` for the port's
`torch.save` runs: the checkpoint that `checkpoints/latest.txt` names
(`epoch_N/` of `run_training` and the demos, `step_N/` of
`run_detector_training`) keeps its parameters, buffers and step and loses
`opt_state`; every other checkpoint directory is deleted except `final/`
(the detector's parameters-only copy). `inference.load_model` reads the
slimmed run as before, and a resumed run restores the weights and the step
with a fresh Adam (`training.train.load_checkpoint`).

    python -m megapose6d_tpu_torch.scripts.slim_run_dir runs/refiner_long [...]
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import torch


def slim_run_dir(run_dir: str | Path) -> Path:
    """Slim `run_dir` in place; returns the kept checkpoint directory."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    latest = ckpt_dir / "latest.txt"
    if not latest.exists():
        raise FileNotFoundError(f"no latest.txt under {ckpt_dir}")
    tag = latest.read_text().strip()
    path = next((p for p in (ckpt_dir / f"epoch_{tag}", ckpt_dir / f"step_{tag}") if (p / "state.pt").exists()),
                None)
    if path is None:
        raise FileNotFoundError(f"{latest} names {tag!r}, and neither epoch_{tag} nor step_{tag} holds a state.pt")
    saved = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    slim = {k: saved[k] for k in ("params", "buffers", "step") if k in saved}
    before = (path / "state.pt").stat().st_size
    tmp = path / "state.pt.slim"
    torch.save(slim, tmp)
    tmp.replace(path / "state.pt")
    after = (path / "state.pt").stat().st_size
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p != path and p.name != "final":
            shutil.rmtree(p)
    print(f"{run_dir}: kept {path.name} ({before / 1e6:.0f} MB -> {after / 1e6:.0f} MB), dropped intermediates")
    return path


if __name__ == "__main__":
    for d in sys.argv[1:]:
        slim_run_dir(d)
