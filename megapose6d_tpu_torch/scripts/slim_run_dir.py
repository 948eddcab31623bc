"""Slim a run directory for keeping: only the latest checkpoint, saved
again without Adam's state.

Counterpart of `megapose6d_tpu/scripts/slim_run_dir.py`, for the JAX
package's runs and the port's own. The checkpoint that
`checkpoints/latest.txt` names (`epoch_N/` of `run_training` and the demos,
`step_N/` of `run_detector_training`) keeps its parameters and step and
loses `opt_state`; every other checkpoint directory is deleted except
`final/` (the detector's parameters-only copy).

  - A JAX run (orbax checkpoints): the checkpoint is read with
    `interop.orbax.read_checkpoint` and its `params` (and `step`, where it
    has one) written again as an orbax checkpoint by `write_checkpoint`,
    into `checkpoints/_slim_<name>` that then takes the old one's place, as
    the JAX script does. The JAX package's `load_checkpoint` (params and
    step, or `params_only=True`), orbax and tensorstore restore it, and so
    does the port.
  - A port run (`state.pt`): saved again with its parameters, buffers and
    step. `inference.load_model` reads the slimmed run as before, and a
    resumed run restores the weights and the step with a fresh Adam
    (`training.train.load_checkpoint`).

    python -m megapose6d_tpu_torch.scripts.slim_run_dir runs/refiner_long [...]
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import torch

from ..interop.orbax import is_orbax_checkpoint, read_checkpoint, top_level_keys, write_checkpoint


def _bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _slim_orbax(path: Path) -> tuple[int, int]:
    """Rewrite the orbax checkpoint `path` with its params and step."""
    keys = [k for k in ("params", "step") if k in top_level_keys(path)]
    tree = read_checkpoint(path, prefixes=keys)
    tmp = path.with_name(f"_slim_{path.name}")
    if tmp.exists():
        shutil.rmtree(tmp)
    write_checkpoint(tmp, {k: tree[k] for k in keys})
    before, after = _bytes(path), _bytes(tmp)
    shutil.rmtree(path)
    tmp.rename(path)
    return before, after


def _slim_state(path: Path) -> tuple[int, int]:
    """Rewrite the port's `state.pt` under `path` with its params, buffers and step."""
    saved = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    slim = {k: saved[k] for k in ("params", "buffers", "step") if k in saved}
    before = (path / "state.pt").stat().st_size
    tmp = path / "state.pt.slim"
    torch.save(slim, tmp)
    tmp.replace(path / "state.pt")
    return before, (path / "state.pt").stat().st_size


def slim_run_dir(run_dir: str | Path) -> Path:
    """Slim `run_dir` in place; returns the kept checkpoint directory."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    latest = ckpt_dir / "latest.txt"
    if not latest.exists():
        raise FileNotFoundError(f"no latest.txt under {ckpt_dir}")
    tag = latest.read_text().strip()
    candidates = (ckpt_dir / f"epoch_{tag}", ckpt_dir / f"step_{tag}")
    path = next((p for p in candidates if is_orbax_checkpoint(p) or (p / "state.pt").exists()), None)
    if path is None:
        raise FileNotFoundError(f"{latest} names {tag!r}, and neither epoch_{tag} nor step_{tag} holds an orbax "
                                "checkpoint or a state.pt")
    before, after = _slim_orbax(path) if is_orbax_checkpoint(path) else _slim_state(path)
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p != path and p.name != "final":
            shutil.rmtree(p)
    print(f"{run_dir}: kept {path.name} ({before / 1e6:.0f} MB -> {after / 1e6:.0f} MB), dropped intermediates")
    return path


if __name__ == "__main__":
    for d in sys.argv[1:]:
        slim_run_dir(d)
