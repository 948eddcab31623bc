"""Slim a run directory for keeping: only the latest checkpoint, saved
again without Adam's state.

Counterpart of `megapose6d_tpu/scripts/slim_run_dir.py` for the port's
`torch.save` runs: the checkpoint that `checkpoints/latest.txt` names
(`epoch_N/` of `run_training` and the demos, `step_N/` of
`run_detector_training`) keeps its parameters, buffers and step and loses
`opt_state`; every other checkpoint directory is deleted except `final/`
(the detector's parameters-only copy). `inference.load_model` reads the
slimmed run as before, and a resumed run restores the weights and the step
with a fresh Adam (`training.train.load_checkpoint`). A JAX run (orbax
checkpoints) raises ValueError: slimming it means writing orbax, which the
port does not do; the JAX package's `scripts/slim_run_dir.py` does.

    python -m megapose6d_tpu_torch.scripts.slim_run_dir runs/refiner_long [...]
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import torch

from ..interop.orbax import is_orbax_checkpoint


def slim_run_dir(run_dir: str | Path) -> Path:
    """Slim `run_dir` in place; returns the kept checkpoint directory."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    latest = ckpt_dir / "latest.txt"
    if not latest.exists():
        raise FileNotFoundError(f"no latest.txt under {ckpt_dir}")
    tag = latest.read_text().strip()
    if any(is_orbax_checkpoint(ckpt_dir / name) for name in (f"epoch_{tag}", f"step_{tag}", "final")):
        raise ValueError(f"{run_dir} is a JAX run (orbax checkpoints): the port writes no orbax; slim it with "
                         "the JAX package's megapose6d_tpu/scripts/slim_run_dir.py")
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
