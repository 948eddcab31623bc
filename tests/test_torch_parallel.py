"""Port vs JAX: the distributed layer and the two multi-device train steps.

One gloo run of two CPU processes (`tests/torch_parallel_worker.py`)
covers the module:
- `reduce_dict` (mean and sum) and `scripts.test_distributed.main`
  exactly; `gather_collections` of the ranks' `shard_frames(7, r, 2)`
  shares against the single-process answer (all 7 rows in frame order),
  as `tests/test_datagen_and_distributed.py::test_two_process_distributed`
  holds the JAX package's;
- the data-parallel step: each rank takes its rows of a global batch of 2
  and of the JAX package's draws for it
  (`tests/torch_training_refs.jax_forward_loss_draws`), gradients and
  metrics averaged over the ranks. It must equal the port's 1-rank step on
  the whole batch (parameters after the update atol 1e-6; the two ranks'
  parameters bit for bit each other's) and the JAX package's
  `make_train_step` with the batch sharded over a 2-device mesh (loss and
  metrics rtol 1e-5; Adam's first moments, 0.1 x the averaged gradients,
  within 1e-4 of each tensor's largest entry, as
  `tests/test_torch_forward_loss.py` holds gradients);
- the label-sharded step: the cube and the sphere split over 2 shards
  (`ShardedMeshDB.build(shard_ids=[rank])`), each rank's batch of 2 with
  LOCAL mesh indices and the draws of its shard's key
  (`fold_in(key, shard)`). It must equal the mean of the port's
  single-process gradients of the two shards (within 1e-5 of each
  tensor's largest entry: float32 sums in another order, one thread in
  the ranks and several here) and the JAX package's `make_sharded_train_step`
  on 2 virtual devices: loss and metrics rtol 1e-5, and each gradient
  tensor within 1e-4 of its largest entry or, where a ReLU or max-pool
  decision flips, within twice its own move when the observations are
  scaled by 1 +- 2^-23 (the rule of `chip_smoke.py`'s card-against-CPU
  checks: on these shards' scenes the two packages' gradients differ by
  1.6-4.6% of a tensor's largest entry even unsharded, with equal meshes
  and losses within 2.6e-6).
- the data-parallel step with the `zoo_resnet18-train` backbone, whose
  BatchNorms normalize over both ranks' rows (SyncBN): it must equal the
  1-rank step (metrics rtol 1e-5; parameters and running statistics atol
  1e-6; the ranks' bit for bit each other's);
- `run_training train_datasets=synthdemo.bop19` on 2 ranks (tiny, one
  step of a global batch of 2, the inline loader): each rank's loader
  gives it 1 sample a batch, the ranks' samples differ, and the ranks end
  with the same parameters.
The refiner case of `tests/test_torch_forward_loss.py` (resnet18-spatial,
48x64 renders of 60x80 observations, float32, 2 views, 2 iterations,
random ambient light), with a clip threshold no gradient reaches. Without
a spawn, `rank_rows` cuts draws of b x H rows (H = 4 coarse hypotheses)
to the rows of a rank's samples.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from megapose6d_tpu.meshes import RigidObject as JRigidObject
from megapose6d_tpu.meshes import RigidObjectDataset as JRigidObjectDataset
from megapose6d_tpu.meshes import make_cube, make_uv_sphere
from megapose6d_tpu.meshes.sharded_db import ShardedMeshDB as JShardedMeshDB
from megapose6d_tpu.ops.camera import masked_boxes_from_uv, project_points_robust
from megapose6d_tpu.parallel.mesh import make_mesh as j_make_mesh
from megapose6d_tpu.parallel.mesh import replicated, shard_batch
from megapose6d_tpu.training.train import TrainState as JTrainState
from megapose6d_tpu.training.train import make_optimizer, make_sharded_train_step, make_train_step
from megapose6d_tpu_torch.interop.from_jax import state_dict_from_jax
from megapose6d_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig
from megapose6d_tpu_torch.ops._precision import pin_f32
from megapose6d_tpu_torch.training import train as tt
from megapose6d_tpu_torch.training.config import TrainingConfig, make_coarse_cfg, make_refiner_cfg
from megapose6d_tpu_torch.meshes.sharded_db import ShardedMeshDB
from megapose6d_tpu_torch.training.forward_loss import BatchPoseData, draw_forward_loss, forward_loss
from tests.torch_parallel_worker import objects
from tests.torch_training_refs import (
    INPUT,
    RENDER,
    JBatchPoseData,
    batches,
    init_jax_model,
    j_db,
    jax_forward_loss_draws,
    jcfg,
    scene,
    t,
    t_db,
)

pin_f32()
ROOT = Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(
    make_refiner_cfg(TrainingConfig(backbone_str="resnet18-spatial", input_resize=INPUT, render_size=RENDER,
                                    batch_size=2, n_points_loss=32, compute_dtype="float32")),
    n_rendered_views=2, multiview_type="front_1view", n_iterations=2, random_ambient_light=True, clip_grad_norm=1e6)
ZOO_CFG = dataclasses.replace(CFG, backbone_str="zoo_resnet18-train")
SHARD_SEED = 3
PADS = dict(n_vertices_pad=128, n_faces_pad=256)
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module, restored after it: the test
    workers' thread pools otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def adam_mu(jstate) -> dict:
    """The JAX state's Adam first moments under the port's names
    (optax: chain(clip, chain(scale_by_adam, scale_by_schedule)))."""
    mu = jstate.opt_state[1][0].mu
    return {k: v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, mu)).items()}


def jax_step(step_fn, params, jmodel, batch, key, mesh):
    state = JTrainState.create(apply_fn=jmodel.apply, params=jax.tree.map(np.array, params),
                               tx=make_optimizer(jcfg(CFG), 1))
    state = jax.device_put(state, replicated(mesh))  # a copy: the step donates its state
    with jax.default_matmul_precision("highest"):
        state, metrics = step_fn(state, batch, key, CFG.n_iterations)
    return {k: float(v) for k, v in metrics.items()}, adam_mu(state)


def shard_batches(jsdb, rng):
    """Per shard, a batch of 2 of its label (local index 0): the port's
    tensors, and the JAX package's shard-major global batch."""
    per_shard, jparts = [], []
    for sid in range(jsdb.n_shards):
        sc = scene(rng, 2, [0, 0])
        pts = jnp.asarray(jsdb.local_shard(sid).points)[jnp.asarray(sc["mesh_idx"])]
        uv = project_points_robust(pts, jnp.asarray(sc["K"]), jnp.asarray(sc["TCO"]))
        boxes = np.asarray(masked_boxes_from_uv(uv, jnp.ones(uv.shape[:2], bool)))
        per_shard.append(dict(rgbs=t(sc["rgbs"]), K=t(sc["K"]), TCO=t(sc["TCO"]), bboxes=t(boxes),
                              mesh_idx=t(sc["mesh_idx"], torch.long)))
        jparts.append(dict(sc, bboxes=boxes))
    cat = lambda k: jnp.asarray(np.concatenate([p[k] for p in jparts]))  # noqa: E731
    jb = JBatchPoseData(rgbs=cat("rgbs"), K=cat("K"), TCO=cat("TCO"), bboxes=cat("bboxes"), mesh_idx=cat("mesh_idx"))
    return per_shard, jb


def spawn(inputs_path: Path, out_dir: Path) -> list[str]:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env_base = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests/torch_parallel_worker.py"), str(inputs_path), str(out_dir)],
        env=dict(env_base, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                 LOCAL_RANK=str(r), OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {r}/2 OK" in log, f"rank {r} failed:\n{log}"
    return logs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' outputs beside the references: the port's 1-rank
    step and the JAX package's two steps."""
    tmp = tmp_path_factory.mktemp("parallel")
    jdb, tdb_ = j_db(), t_db()
    jb, tb = batches(scene(np.random.RandomState(2), 2, [0, 1]), jdb, tdb_)
    jmodel, params = init_jax_model(CFG, jdb, seed=4)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    key = jax.random.PRNGKey(9)
    mesh = j_make_mesh(2)

    dp_draws = jax_forward_loss_draws(key, CFG, 2, tdb_.points.shape[1])
    j_dp = jax_step(make_train_step(jmodel, jcfg(CFG), jdb), params, jmodel, shard_batch(jb, mesh), key, mesh)

    jobjs = JRigidObjectDataset([JRigidObject(label="cube", mesh=make_cube(0.04)),
                                 JRigidObject(label="sphere", mesh=make_uv_sphere(0.035, 8, 12))])
    jsdb = JShardedMeshDB.build(jobjs, n_shards=2, device_mesh=mesh, seed=SHARD_SEED, max_faces=256, n_points=128,
                                n_sym=4, align=32, **PADS)
    sh_batches, jsb = shard_batches(jsdb, np.random.RandomState(5))
    jsb = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, P("dp"))), jsb)
    j_sh = jax_step(make_sharded_train_step(jmodel, jcfg(CFG), jsdb, mesh), params, jmodel, jsb, key, mesh)
    sh_draws = [jax_forward_loss_draws(jax.random.fold_in(key, r), CFG, 2, 128) for r in range(2)]

    zoo = PosePredictor(PosePredictorConfig(**ZOO_CFG.model_config_kwargs()))
    zoo_sd = {k: v.clone() for k, v in zoo.init_weights(torch.Generator().manual_seed(4)).state_dict().items()}
    dataset_args = ["config_id=refiner", "train_datasets=synthdemo.bop19", f"data_dir={ROOT / 'runs/ar_dr'}",
                    "epoch_size=2", "batch_size=2", "n_epochs=1", "input_resize=48,64", "render_size=32,48",
                    "n_rendered_views=1", "multiview_type=front_1view", "n_points_loss=32", "max_faces=128",
                    "n_points_mesh=64", "backbone_str=resnet18", "min_area=10", "n_dataloader_workers=0",
                    "device=cpu", f"run_dir={tmp}", "run_id=dataset_fed"]
    inputs = {"cfg": dataclasses.asdict(CFG), "state_dict": sd, "zoo_cfg": dataclasses.asdict(ZOO_CFG),
              "zoo_state_dict": zoo_sd, "dataset_args": dataset_args,
              "data_parallel": {"batch": dataclasses.asdict(tb), "db": tdb_, "draws": dp_draws},
              "label_sharded": {"seed": SHARD_SEED, "pads": PADS, "batches": sh_batches, "draws": sh_draws}}
    torch.save(inputs, tmp / "inputs.pt")
    spawn(tmp / "inputs.pt", tmp)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]

    model = PosePredictor(PosePredictorConfig(**CFG.model_config_kwargs()))
    model.load_state_dict(sd)
    state = tt.TrainState(step=0, opt_state=tt.Adam.init(list(model.parameters())), model=model,
                          optimizer=tt.Adam(tt.make_lr_schedule(CFG, 1)))
    one_rank = tt.train_step(state, CFG, tb, tdb_, dp_draws, CFG.n_iterations)
    one_rank_params = {n: p.detach() for n, p in model.named_parameters()}
    zoo.load_state_dict(zoo_sd)
    state = tt.TrainState(step=0, opt_state=tt.Adam.init(list(zoo.parameters())), model=zoo,
                          optimizer=tt.Adam(tt.make_lr_schedule(ZOO_CFG, 1)))
    zoo_metrics = tt.train_step(state, ZOO_CFG, tb, tdb_, dp_draws, ZOO_CFG.n_iterations)
    labels = [list(jsdb.batched.labels[r * jsdb.per_shard:(r + 1) * jsdb.per_shard]) for r in range(2)]
    return dict(ranks=ranks, j_dp=j_dp, j_sh=j_sh, one_rank=(one_rank, one_rank_params), j_labels=labels,
                shard_grads=shard_grads(sd, sh_batches, sh_draws), run_dir=tmp / "dataset_fed",
                zoo_one_rank=(zoo_metrics, {n: p.detach() for n, p in zoo.named_parameters()},
                              {n: b.clone() for n, b in zoo.named_buffers()}, zoo_sd))


def shard_grads(sd: dict, sh_batches: list, sh_draws: list) -> tuple[dict, dict]:
    """The mean over the two shards of the port's single-process
    gradients, and each tensor's largest move when every observation is
    scaled by 1 +- 2^-23."""
    sdb = ShardedMeshDB.build(objects(), 2, device_mesh="cpu", seed=SHARD_SEED, max_faces=256, n_points=128, n_sym=4,
                              align=32, **PADS)

    def mean_grads(scale: float) -> dict:
        out = {}
        for r in range(2):
            model = PosePredictor(PosePredictorConfig(**CFG.model_config_kwargs()))
            model.load_state_dict(sd)
            b = BatchPoseData(**dict(sh_batches[r], rgbs=sh_batches[r]["rgbs"] * scale))
            loss, _ = forward_loss(model, CFG, b, sdb.local_shard(r), CFG.n_iterations, sh_draws[r])
            for (n, _), g in zip(model.named_parameters(), torch.autograd.grad(loss, list(model.parameters()))):
                out[n] = out.get(n, 0) + g.numpy() / 2
        return out

    ref = mean_grads(1.0)
    moves = [gaps(mean_grads(1 + s * 2.0**-23), ref) for s in (1, -1)]
    return ref, {n: max(m[n] for m in moves) for n in ref}


def test_reduce_dict_and_collective(run):
    for out in run["ranks"]:
        assert out["reduced"] == {"acc": 0.5, "loss": 1.5}
        assert out["summed"] == {"x": 3.0}
        assert out["collective_sum"] == 1.0  # world * (world - 1) / 2


def test_gather_collections_matches_single_process(run):
    g = run["ranks"][0]["gathered"]
    assert g["infos"]["frame_id"].tolist() == list(range(7))
    assert g["infos"]["label"].tolist() == [f"obj_{i}" for i in range(7)]
    np.testing.assert_allclose(g["infos"]["score"], np.arange(7) / 10.0)
    np.testing.assert_allclose(g["scores"].numpy(), np.arange(7) / 10.0, atol=1e-7)
    np.testing.assert_allclose(g["poses"][:, 0, 0].numpy(), np.arange(1.0, 8.0))
    assert "gathered" not in run["ranks"][1]


def gaps(a: dict, b: dict) -> dict:
    """Per tensor, the largest difference over the largest entry of `b`."""
    return {n: float(np.abs(np.asarray(a[n]) - np.asarray(b[n])).max() / np.abs(np.asarray(b[n])).max()) for n in b}


def assert_step_matches_jax(out: dict, jax_ref, room: dict | None = None) -> None:
    jmetrics, jmu = jax_ref
    for k, v in jmetrics.items():
        np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-5, err_msg=k)
    gap = gaps({n: m.numpy() for n, m in out["mu"].items()}, jmu)
    for n, g in gap.items():
        assert g <= max(GRAD_TOL, 2 * (room or {}).get(n, 0.0)), (n, g, (room or {}).get(n))
    assert max(gap.values()) > 0  # computed apart


@pytest.mark.parametrize("step", ["data_parallel", "label_sharded"])
def test_two_rank_step_matches_jax(run, step):
    a, b = (r[step] for r in run["ranks"])
    for n in a["params"]:  # one all-reduced buffer: the ranks update alike
        assert torch.equal(a["params"][n], b["params"][n]), n
    assert a["metrics"] == b["metrics"]
    if step == "data_parallel":
        assert_step_matches_jax(a, run["j_dp"])
    else:
        ref, moves = run["shard_grads"]
        assert max(gaps({n: m.numpy() / 0.1 for n, m in a["mu"].items()}, ref).values()) <= 1e-5
        assert_step_matches_jax(a, run["j_sh"], room=moves)


def test_data_parallel_step_equals_one_rank(run):
    one, params = run["one_rank"]
    two = run["ranks"][0]["data_parallel"]
    for k, v in one.items():
        np.testing.assert_allclose(two["metrics"][k], v, rtol=1e-5, err_msg=k)
    for n, p in params.items():
        np.testing.assert_allclose(two["params"][n].numpy(), p.numpy(), rtol=0, atol=1e-6, err_msg=n)


def test_zoo_train_two_rank_step_equals_one_rank(run):
    """BatchNorm's statistics over both ranks' rows: the 2-rank step is
    the 1-rank step, running statistics included."""
    metrics, params, buffers, initial = run["zoo_one_rank"]
    a, b = (r["zoo_train"] for r in run["ranks"])
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for n in a["buffers"]:
        assert torch.equal(a["buffers"][n], b["buffers"][n]), n
    for k, v in metrics.items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=1e-5, err_msg=k)
    for n, p in params.items():
        np.testing.assert_allclose(a["params"][n].numpy(), p.numpy(), rtol=0, atol=1e-6, err_msg=n)
    assert len(buffers) > 0
    for n, v in buffers.items():
        assert not torch.equal(v, initial[n]), n  # the running statistics moved
        np.testing.assert_allclose(a["buffers"][n].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=n)


def test_dataset_fed_ranks_load_their_own_samples(run):
    a, b = (r["dataset_fed"] for r in run["ranks"])
    assert a["steps"] == b["steps"] == 1
    assert [x.shape[0] for x in a["rgbs"] + b["rgbs"]] == [1, 1]  # batch_size / 2 a rank
    assert not torch.equal(a["rgbs"][0], b["rgbs"][0])
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    log = (run["run_dir"] / "log.txt").read_text().splitlines()
    assert len(log) == 1 and np.isfinite(json.loads(log[0])["loss_total"])


def test_label_shards_hold_the_jax_split(run):
    for r, out in enumerate(run["ranks"]):
        assert list(out["label_sharded"]["local_labels"]) == run["j_labels"][r]


def test_rank_rows_cut_draws_by_sample():
    """Draws of b x H rows (the coarse grid's hypotheses) and of b rows,
    cut to rank r's samples: the rows of samples [r b / W, (r + 1) b / W)."""
    cfg = dataclasses.replace(make_coarse_cfg(TrainingConfig()), n_hypotheses=4, random_ambient_light=True)
    draws = draw_forward_loss(cfg, 6, 16, torch.Generator().manual_seed(0))
    for r in range(3):
        mine = tt.rank_rows(draws, r, 3)
        assert torch.equal(mine["ambient"], draws["ambient"].reshape(6, 4)[2 * r:2 * r + 2].reshape(-1))
        assert torch.equal(mine["hyp"]["rot"], draws["hyp"]["rot"][2 * r:2 * r + 2])
        assert torch.equal(mine["point_scores"], draws["point_scores"][2 * r:2 * r + 2])
