"""Port vs JAX: sharded inference where the hypotheses do not fill the
devices' chunks.

The setup of `tests/test_torch_sharded_inference.py` (one cube, SO(3)
grid 16, one refiner iteration) with 3 hypotheses, refiner chunks of 2
and coarse chunks of 3 on the mesh `[cpu, cpu]`: the coarse sweep pads
16 rows to 18 and the refiner and rescore 3 to 4, each with identity
poses (z = 0) of mesh 0 inside a live chunk. Held with that module's
tolerances: against the port unsharded (coarse logits atol 2e-4, final
poses atol 1e-4, everything finite) and against the JAX package's sharded
run on a 2-device mesh, which pads the same way.
"""

import pytest
import torch

from tests.test_torch_sharded_inference import check_against_jax, check_against_unsharded, run_cases

PADDED = {"padded": dict(n_pose_hypotheses=3, bsz_images=3)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module, restored after it: the test
    workers' thread pools otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inference():
    return run_cases(PADDED)


def test_padded_sharded_inference_matches_unsharded(inference):
    check_against_unsharded(inference, "padded", PADDED["padded"], pruned=False, padded=True)


def test_padded_sharded_inference_matches_jax_sharded(inference):
    check_against_jax(inference, "padded")
