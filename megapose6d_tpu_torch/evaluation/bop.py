"""BOP-challenge results CSV and the bop_toolkit bridge.

Counterpart of `megapose6d_tpu/evaluation/bop.py`. The CSV
(`scene_id,im_id,obj_id,score,R,t,time`, R row-major and space-separated,
t in millimeters) is written byte for byte as the JAX package writes it,
so bop_toolkit's `eval_bop19.py` reads it unchanged.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

from ..data.tensor_collection import TensorCollection


def label_to_obj_id(label: str) -> int:
    """BOP convention: 'obj_000014' / 'ycbv-obj_000002' -> 14 / 2."""
    tail = str(label).split("_")[-1]
    if not tail.lstrip("-").isdigit():
        raise ValueError(f"label {label!r} has no numeric obj_id suffix; pass "
                         "obj_id_map={label: id} to convert_results_to_bop")
    return int(tail)


def convert_results_to_bop(
    predictions: TensorCollection,
    out_csv_path: str | Path,
    use_pose_score: bool = True,
    obj_id_map: dict[str, int] | None = None,
) -> Path:
    """Pose estimates -> BOP19 CSV. `predictions.infos` carries scene_id,
    view_id, label (and pose_score or score, time); `predictions.poses` is
    `[N, 4, 4]` in meters."""
    infos = predictions.infos
    poses = np.asarray(predictions.poses.cpu())
    rows = []
    for n in range(len(predictions)):
        T = poses[n]
        label = str(infos["label"][n])
        obj_id = int(obj_id_map[label]) if obj_id_map is not None else label_to_obj_id(label)
        if use_pose_score and "pose_score" in infos:
            score = infos["pose_score"][n]
        else:
            score = infos["score"][n] if "score" in infos else 1.0
        time = infos["time"][n] if "time" in infos else -1
        rows.append("{},{},{},{},{},{},{}".format(
            int(infos["scene_id"][n]), int(infos["view_id"][n]), obj_id, float(score),
            " ".join(f"{x:.8f}" for x in T[:3, :3].reshape(-1)),
            " ".join(f"{x:.8f}" for x in T[:3, 3] * 1e3),  # m -> mm
            float(time),
        ))
    out = Path(out_csv_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("scene_id,im_id,obj_id,score,R,t,time\n" + "\n".join(rows) + "\n")
    return out


def load_bop_results(csv_path: str | Path) -> list[dict]:
    """Parse a BOP results CSV back."""
    out = []
    for line in Path(csv_path).read_text().strip().splitlines()[1:]:
        sc, im, obj, score, R, t, time = line.split(",")
        out.append(dict(
            scene_id=int(sc), im_id=int(im), obj_id=int(obj), score=float(score),
            R=np.array(R.split(), float).reshape(3, 3), t=np.array(t.split(), float),
            time=float(time),
        ))
    return out


def run_bop_evaluation(
    filename: str | Path,
    eval_dir: str | Path,
    bop_toolkit_dir: str | Path | None = None,
    dummy: bool = False,
) -> subprocess.CompletedProcess | None:
    """Score a results CSV with bop_toolkit's `eval_bop19.py` in a
    subprocess; None when the toolkit is not there."""
    if bop_toolkit_dir is None:
        return None
    script = Path(bop_toolkit_dir) / "scripts" / ("eval_bop19_dummy.py" if dummy else "eval_bop19.py")
    if not script.exists():
        return None
    cmd = [sys.executable, str(script), "--renderer_type", "cpp",
           "--results_path", str(Path(filename).parent), "--eval_path", str(eval_dir),
           "--result_filenames", Path(filename).name]
    return subprocess.run(cmd, capture_output=True, text=True)
