"""Import hygiene of the port: with JAX, flax, orbax, pandas, PIL and the
JAX package blocked, every module of `megapose6d_tpu_torch` and
`chip_smoke` imports; and the port's entry points default to `cuda`."""

import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCKER = r"""
import importlib.abc, importlib.util, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "PIL", "megapose6d_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
import megapose6d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(megapose6d_tpu_torch.__path__, "megapose6d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_without_jax_pandas_or_pil():
    proc = subprocess.run(
        [sys.executable, "-c", "import json\n" + BLOCKER], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    expected = {
        "megapose6d_tpu_torch.ops.rasterizer_tiled", "megapose6d_tpu_torch.meshes.mesh_db",
        "megapose6d_tpu_torch.models.pose_predictor", "megapose6d_tpu_torch.interop.from_jax",
        "megapose6d_tpu_torch.inference.pose_estimator", "megapose6d_tpu_torch.data.types",
        "megapose6d_tpu_torch.utils.png", "megapose6d_tpu_torch.inference.load_model",
        "megapose6d_tpu_torch.data.bop_scene_dataset", "megapose6d_tpu_torch.data.datasets_cfg",
        "megapose6d_tpu_torch.evaluation.meters", "megapose6d_tpu_torch.evaluation.vsd",
        "megapose6d_tpu_torch.evaluation.bop", "megapose6d_tpu_torch.evaluation.evaluation",
        "megapose6d_tpu_torch.scripts.run_eval",
    }
    assert expected <= set(out["modules"])


def test_entry_points_default_to_cuda():
    from megapose6d_tpu_torch.data.types import ObservationTensor
    from megapose6d_tpu_torch.inference.pose_estimator import PoseEstimator
    from megapose6d_tpu_torch.inference.types import make_detections
    from megapose6d_tpu_torch.meshes.mesh_db import MeshDataBase
    from megapose6d_tpu_torch.models.pose_predictor import build_pose_predictor
    from megapose6d_tpu_torch.ops.so3_grid import make_so3_grid

    from megapose6d_tpu_torch.evaluation.eval_config import EvalConfig
    from megapose6d_tpu_torch.inference.load_model import build_model, load_or_init_models

    assert EvalConfig().device == "cuda"
    for fn in (PoseEstimator.__init__, make_detections, MeshDataBase.batched,
               build_pose_predictor, make_so3_grid, ObservationTensor.from_numpy,
               build_model, load_or_init_models):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
