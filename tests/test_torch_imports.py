"""Import hygiene of the port: with JAX, flax, orbax, tensorstore,
zstandard, pandas, PIL and the JAX package blocked, every module of `megapose6d_tpu_torch` and
`chip_smoke` imports; and the port's entry points default to `cuda`."""

import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCKER = r"""
import importlib.abc, importlib.util, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard", "pandas", "PIL",
           "megapose6d_tpu")

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
        "megapose6d_tpu_torch.scripts.run_eval", "megapose6d_tpu_torch.utils.threefry",
        "megapose6d_tpu_torch.ops.icp", "megapose6d_tpu_torch.ops.registration",
        "megapose6d_tpu_torch.inference.depth_refiner",
        "megapose6d_tpu_torch.scripts.run_inference_on_example",
        "megapose6d_tpu_torch.scripts.demo_ar_baseline",
        "megapose6d_tpu_torch.ops.losses", "megapose6d_tpu_torch.training.config",
        "megapose6d_tpu_torch.training.forward_loss", "megapose6d_tpu_torch.training.train",
        "megapose6d_tpu_torch.scripts.run_training",
        "megapose6d_tpu_torch.scripts.demo_synthetic_e2e", "megapose6d_tpu_torch.scripts.demo_finalize_pipeline",
        "megapose6d_tpu_torch.models.detector", "megapose6d_tpu_torch.data.bop_writer",
        "megapose6d_tpu_torch.data.web_scene_dataset", "megapose6d_tpu_torch.scripts.generate_synthetic_dataset",
        "megapose6d_tpu_torch.scripts.run_detector_training", "megapose6d_tpu_torch.scripts.run_full_eval",
        "megapose6d_tpu_torch.meshes.worlds", "megapose6d_tpu_torch.bop_config",
        "megapose6d_tpu_torch.native", "megapose6d_tpu_torch.utils.imaging",
        "megapose6d_tpu_torch.data.augmentations", "megapose6d_tpu_torch.data.pose_dataset",
        "megapose6d_tpu_torch.data.loader", "megapose6d_tpu_torch.data.object_datasets",
        "megapose6d_tpu_torch.data.modelnet",
        "megapose6d_tpu_torch.parallel.distributed", "megapose6d_tpu_torch.parallel.mesh",
        "megapose6d_tpu_torch.meshes.sharded_db", "megapose6d_tpu_torch.interop.torch_convert",
        "megapose6d_tpu_torch.scripts.test_distributed", "megapose6d_tpu_torch.utils.ocdbt",
        "megapose6d_tpu_torch.interop.orbax", "megapose6d_tpu_torch.scripts.slim_run_dir",
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
    from megapose6d_tpu_torch.inference.load_model import build_model, load_named_model, load_or_init_models
    from megapose6d_tpu_torch.evaluation.evaluation import load_detector
    from megapose6d_tpu_torch.meshes import worlds
    from megapose6d_tpu_torch.scripts import (
        demo_ar_baseline, demo_finalize_pipeline, generate_synthetic_dataset,
        run_detector_training, run_inference_on_example, run_training,
    )
    from megapose6d_tpu_torch.training.train import create_train_state, synthetic_batch_fn

    assert EvalConfig().device == "cuda"
    for fn in (PoseEstimator.__init__, make_detections, MeshDataBase.batched,
               build_pose_predictor, make_so3_grid, ObservationTensor.from_numpy,
               build_model, load_or_init_models, load_named_model,
               run_inference_on_example.load_observation, create_train_state, synthetic_batch_fn,
               worlds.build_world, load_detector, worlds.build_bop_world):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert demo_ar_baseline.DEFAULTS["device"] == "cuda"
    assert demo_finalize_pipeline.DEFAULTS["device"] == "cuda"
    assert run_training.META["device"] == "cuda"
    assert generate_synthetic_dataset.DEFAULTS["device"] == run_detector_training.DEFAULTS["device"] == "cuda"
