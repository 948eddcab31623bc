"""Calls written against the JAX package give the JAX results on the port:
`load_named_model` with the JAX package's `runs` on the committed runs.

Tolerances are stated in the test's docstring.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RUNS = ROOT / "runs"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops gain nothing from threads and slow down many times
    over when the test workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_load_named_model_runs():
    """`load_named_model(name, objects, runs, max_faces, compute_dtype)`
    with `runs` naming the committed coarse and refiner runs: the JAX
    package's weights (each tensor exactly) and inference parameters."""
    from megapose6d_tpu.inference.load_model import load_named_model as jload
    from megapose6d_tpu.meshes import RigidObject as JObject
    from megapose6d_tpu.meshes import RigidObjectDataset as JObjects
    from megapose6d_tpu.meshes import make_cube as jcube
    from megapose6d_tpu_torch.inference.load_model import load_named_model
    from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
    from megapose6d_tpu_torch.meshes import io as tio
    from megapose6d_tpu_torch.meshes import mesh_db as tdb

    runs = {"coarse": RUNS / "coarse_dr", "refiner": RUNS / "refiner_dr"}
    name = "megapose-1.0-RGB-multi-hypothesis"
    j = jload(name, JObjects([JObject(label="cube", mesh=jcube(0.04))]), runs, 64, "float32")
    t = load_named_model(name, tdb.RigidObjectDataset([tdb.RigidObject(label="cube", mesh=tio.make_cube(0.04))]),
                         runs, 64, "float32", device="cpu")
    assert dataclasses.asdict(t.cfg) == {k: v for k, v in dataclasses.asdict(j.cfg).items() if k in
                                         dataclasses.asdict(t.cfg)}
    for tm, params in ((t.coarse_model, j.coarse_params), (t.refiner_model, j.refiner_params)):
        want = state_dict_from_jax(jax.tree.map(np.asarray, params))
        got = tm.state_dict()
        assert want.keys() <= got.keys()
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v), k
