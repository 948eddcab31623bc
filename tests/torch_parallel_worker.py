"""One rank of `tests/test_torch_parallel.py`'s two-process run (gloo, CPU).

    python tests/torch_parallel_worker.py <inputs.pt> <out_dir>

with `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` set. The rank
joins the group (`init_distributed_mode`), then runs, in order:
  1. `reduce_dict` of {"loss": rank + 1, "acc": 0.5};
  2. `scripts.test_distributed.main` (one all-reduce);
  3. `gather_collections` of its `shard_frames(7, rank, 2)` share of a
     synthetic prediction table;
  4. the data-parallel train step on its rows of the global batch and of
     the given draws (the JAX package's);
  5. the label-sharded train step on its own shard of the cube and sphere
     (`ShardedMeshDB.build(shard_ids=[rank])`), with its shard's batch and
     draws;
  6. step 4 with the `zoo_resnet18-train` backbone (BatchNorm on the
     batch's statistics, over both ranks' rows);
  7. `run_training train_datasets=synthdemo.bop19` (tiny, one step, the
     inline loader), recording the batches its loader gave this rank;
and writes `<out_dir>/rank<r>.pt`. Imports neither JAX nor the JAX
package.
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from megapose6d_tpu_torch.data.tensor_collection import TensorCollection  # noqa: E402
from megapose6d_tpu_torch.evaluation.runner import shard_frames  # noqa: E402
from megapose6d_tpu_torch.meshes import io as tio  # noqa: E402
from megapose6d_tpu_torch.meshes.mesh_db import RigidObject, RigidObjectDataset  # noqa: E402
from megapose6d_tpu_torch.meshes.sharded_db import ShardedMeshDB  # noqa: E402
from megapose6d_tpu_torch.models.pose_predictor import PosePredictor, PosePredictorConfig  # noqa: E402
from megapose6d_tpu_torch.ops._precision import pin_f32  # noqa: E402
from megapose6d_tpu_torch.parallel.distributed import gather_collections, init_distributed_mode, reduce_dict  # noqa: E402
from megapose6d_tpu_torch.scripts import run_training, test_distributed  # noqa: E402
from megapose6d_tpu_torch.training import train as tt  # noqa: E402
from megapose6d_tpu_torch.training.config import TrainingConfig  # noqa: E402
from megapose6d_tpu_torch.training.forward_loss import BatchPoseData  # noqa: E402


def objects() -> RigidObjectDataset:
    """`tests/torch_training_refs.t_db`'s cube and sphere."""
    return RigidObjectDataset([RigidObject(label="cube", mesh=tio.make_cube(0.04)),
                               RigidObject(label="sphere", mesh=tio.make_uv_sphere(0.035, 8, 12))])


def step(inputs: dict, batch: BatchPoseData, db, draws: dict, cfg_key: str = "cfg",
         weights_key: str = "state_dict") -> dict:
    """One train step averaged over the group; the metrics, Adam's first
    moments (0.1 x the averaged gradients, unclipped), the parameters and
    the buffers (BatchNorm's running statistics)."""
    cfg = TrainingConfig(**inputs[cfg_key])
    model = PosePredictor(PosePredictorConfig(**cfg.model_config_kwargs()))
    model.load_state_dict(inputs[weights_key])
    state = tt.TrainState(step=0, opt_state=tt.Adam.init(list(model.parameters())), model=model,
                          optimizer=tt.Adam(tt.make_lr_schedule(cfg, 1)))
    metrics = tt.train_step(state, cfg, batch, db, draws, cfg.n_iterations, reduce_over=dist.group.WORLD)
    names = [n for n, _ in model.named_parameters()]
    return {"metrics": metrics, "mu": dict(zip(names, state.opt_state["mu"])),
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


class RecordedLoader:
    """A dataset loader that keeps the observations of each batch it gives."""

    def __init__(self, loader):
        self.loader, self.rgbs = loader, []

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.loader)
        self.rgbs.append(batch.rgbs.clone())
        return batch

    def close(self):
        self.loader.close()


def dataset_fed(args: list[str]) -> dict:
    """`run_training.main(args)` on this rank, its loader recorded; the
    batches it gave and the parameters after."""
    loaders = []
    make = run_training.dataset_loader

    def recorded(*a, **k):
        loaders.append(RecordedLoader(make(*a, **k)))
        return loaders[-1]

    run_training.dataset_loader = recorded
    try:
        state = run_training.main(args)
    finally:
        run_training.dataset_loader = make
    return {"rgbs": loaders[0].rgbs, "steps": state.step,
            "params": {n: p.detach().clone() for n, p in state.model.named_parameters()}}


def main() -> None:
    inputs = torch.load(sys.argv[1], weights_only=False)
    out_dir = Path(sys.argv[2])
    torch.set_num_threads(1)
    pin_f32()
    rank, world = init_distributed_mode()
    assert world == int(os.environ["WORLD_SIZE"]) and dist.get_backend() == "gloo", (rank, world)
    out: dict = {"reduced": reduce_dict({"loss": float(rank + 1), "acc": 0.5}),
                 "summed": reduce_dict({"x": float(rank + 1)}, average=False),
                 "collective_sum": test_distributed.main()}

    ids = shard_frames(7, rank, world)  # ragged shares: 4 and 3 frames
    local = TensorCollection(infos={"label": [f"obj_{i}" for i in ids], "frame_id": ids,
                                    "score": ids / 10.0},
                             poses=torch.stack([torch.eye(4) * (i + 1) for i in ids]),
                             scores=torch.as_tensor(ids, dtype=torch.float32) / 10.0)
    gathered = gather_collections(local)
    if rank == 0:
        out["gathered"] = {"infos": gathered.infos, "poses": gathered.poses, "scores": gathered.scores}
    else:
        assert gathered is None

    dp = inputs["data_parallel"]
    batch = tt.rank_rows(BatchPoseData(**dp["batch"]), rank, world)
    out["data_parallel"] = step(inputs, batch, dp["db"], tt.rank_rows(dp["draws"], rank, world))

    sh = inputs["label_sharded"]
    db = ShardedMeshDB.build(objects(), n_shards=world, device_mesh="cpu", seed=sh["seed"], shard_ids=[rank],
                             max_faces=256, n_points=128, n_sym=4, align=32, **sh["pads"])
    out["label_sharded"] = step(inputs, BatchPoseData(**sh["batches"][rank]), db.local_shard(rank),
                                sh["draws"][rank])
    out["label_sharded"]["local_labels"] = db.local_shard(rank).labels

    out["zoo_train"] = step(inputs, batch, dp["db"], tt.rank_rows(dp["draws"], rank, world), "zoo_cfg",
                            "zoo_state_dict")
    out["dataset_fed"] = dataset_fed(inputs["dataset_args"])
    torch.save(out, out_dir / f"rank{rank}.pt")
    dist.destroy_process_group()
    print(f"rank {rank}/{world} OK", flush=True)


if __name__ == "__main__":
    main()
