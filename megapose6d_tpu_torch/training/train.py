"""Training: the optimizer and its schedule, the train step, synthetic
batches rendered on the device, checkpoints and the loop.

Counterpart of `megapose6d_tpu/training/train.py`:
  - Adam (AdamW when `weight_decay > 0`) after clipping by the global
    norm, both in optax's arithmetic (`Adam`, `clip_by_global_norm`); the
    schedule sees the count of updates before the current one, so the
    first update uses `lr / warmup_steps`.
  - Parameters are float32; the CNN computes in `compute_dtype` (bfloat16
    for the committed runs) with float32 GroupNorm statistics.
  - Each step's draws come from CPU generators seeded by (seed, stream,
    step) (`step_generator`), so a resumed run replays the draws of an
    unbroken one. The JAX package folds the step into its key instead.
  - Checkpoints keep the JAX package's layout, `run_dir/config.json`,
    `checkpoints/epoch_N/` and `checkpoints/latest.txt`, with
    `torch.save` in place of orbax (`epoch_N/state.pt`). A JAX run's
    orbax checkpoints are read too (`resume_run_id`, `pretrain_run_id`).
  - Data parallelism is one process per device (`parallel.distributed`):
    rank r of W takes rows [r b / W, (r + 1) b / W) of each step's global
    batch of b and the same rows of its draws, and the gradients and
    metrics are averaged over the ranks (one all-reduce of one flat
    buffer, the counterpart of `pmean`) before the clip and Adam, so a
    W-rank step is the 1-rank step on the same global batch, as the JAX
    package's GSPMD step is its single-device step. The batch-statistics
    BatchNorms of `zoo_resnet*-train` normalize over all the ranks' rows
    (SyncBN). The model's methods are called directly, not through
    `forward`, so DDP's reducer hooks would not fire: the step
    all-reduces itself. Fed by a dataset, each rank has a loader of its
    own (b / W samples a batch, a seed stream of its own), as the
    reference's ranks do, so no rank decodes another's samples.
  - The label-sharded step (the JAX package's `make_sharded_train_step`)
    is the same step on a rank's own shard of a `meshes.sharded_db`
    database, with local mesh indices and draws that carry the shard
    index (`step_draws(..., shard=)`).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from ..interop.from_jax import state_dict_from_jax
from ..interop.orbax import is_orbax_checkpoint, read_checkpoint
from ..meshes.mesh_db import BatchedMeshes
from ..models.backbones import synced_batch_stats
from ..models.pose_predictor import PosePredictor, PosePredictorConfig
from ..ops import cropping, rasterizer, rasterizer_tiled
from ..ops.camera import masked_boxes_from_uv, project_points_robust
from ..ops.se3 import make_se3, rotmat_from_quat
from ..ops.so3_grid import super_fibonacci_quats
from ..parallel.mesh import batch_sharding
from .config import TrainingConfig, save_config
from .forward_loss import BatchPoseData, draw_forward_loss, draws_to, forward_loss

Tensor = torch.Tensor

# Streams of `step_generator`.
DRAW_STREAM, BATCH_STREAM, VAL_DRAW_STREAM, VAL_BATCH_STREAM = 0, 1, 2, 3
# Validation batches per validation epoch of `scripts/run_training`'s
# synthetic runs.
N_VAL_BATCHES = 2


def step_generator(seed: int, stream: int, index: int, shard: int = 0) -> torch.Generator:
    """A CPU generator for draw `index` (a step, or a validation batch) of
    `stream`, a function of (seed, stream, index) only; `shard` (a label
    shard's index) mixes in a further stream, as the JAX package's sharded
    step folds its device's index into the key."""
    s = ((seed & 0xFFFFF) << 40) | ((stream & 0xFF) << 32) | (index & 0xFFFFFFFF)
    if shard:
        s ^= (shard * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    return torch.Generator().manual_seed(s)


def rank_rows(tree, rank: int, world: int):
    """Rank `rank`'s rows of every tensor in `tree` (a tensor, a
    `BatchPoseData` or a nested dict, None kept): the r-th of `world`
    equal contiguous parts of the leading axis. A tensor of b * k rows,
    laid out sample-major, gives the rows of the rank's samples."""
    if world == 1 or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: rank_rows(v, rank, world) for k, v in tree.items()}
    if isinstance(tree, BatchPoseData):
        return tree._map(lambda t: rank_rows(t, rank, world))
    return tree[batch_sharding(tree.shape[0], world)[rank]]


def all_reduce_mean(tensors: list[Tensor], group) -> list[Tensor]:
    """`pmean` over the ranks of `group`: the tensors flattened into one
    float32 buffer, all-reduced (sum) once, divided by the group's size
    and cut back into their shapes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def make_lr_schedule(cfg: TrainingConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate of the update that follows `count` updates: linear
    warm-up over `n_epochs_warmup` epochs, then 10x less every
    `lr_epoch_decay` epochs."""
    warmup_steps = max(1, cfg.n_epochs_warmup * steps_per_epoch)
    decay_steps = max(1, cfg.lr_epoch_decay * steps_per_epoch)

    def schedule(count: int) -> float:
        warm = min((count + 1) / warmup_steps, 1.0)
        return cfg.lr * warm * 0.1 ** (count // decay_steps)

    return schedule


def global_norm(tensors: list[Tensor]) -> Tensor:
    """sqrt of the sum of squares of every entry, a 0-d float32 tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads: list[Tensor], norm: Tensor, max_norm: float) -> list[Tensor]:
    """optax's `clip_by_global_norm`: the gradients as they are when
    `norm < max_norm`, else each scaled as `(g / norm) * max_norm`, chosen
    on the device so the host does not wait for the norm.
    (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm.)"""
    keep = norm < max_norm
    scaled = torch._foreach_div(grads, norm)
    torch._foreach_mul_(scaled, max_norm)
    return [torch.where(keep, g, s) for g, s in zip(grads, scaled)]


class Adam:
    """optax's `adam` (`adamw` with decoupled `weight_decay > 0`) on a
    list of parameters, in optax's order of operations. The state is
    `{"count": updates so far, "mu": [...], "nu": [...]}`."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, schedule: Callable[[int], float], weight_decay: float = 0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay

    @staticmethod
    def init(params: list[Tensor]) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params: list[Tensor], grads: list[Tensor], state: dict) -> None:
        """One update of `params` in place; advances `state`."""
        b1, b2 = self.b1, self.b2
        mu, nu = state["mu"], state["nu"]
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        g1 = torch._foreach_mul(grads, 1 - b1)  # mu = (1 - b1) g + b1 mu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g1)
        g2 = torch._foreach_mul(grads, grads)  # nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        mu_hat = torch._foreach_div(mu, float(1 - torch.tensor(b1) ** count))
        nu_hat = torch._foreach_div(nu, float(1 - torch.tensor(b2) ** count))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        state["count"] = count


@dataclasses.dataclass
class TrainState:
    """The step, Adam's state, the model (float32 parameters) and Adam.
    The JAX package's `apply_fn`, `params` and `tx` are the model's
    `forward`, its parameters (`params`) and `optimizer`."""

    step: int
    opt_state: dict
    model: PosePredictor
    optimizer: Adam

    @property
    def params(self) -> list[Tensor]:
        return list(self.model.parameters())

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads: list[Tensor], clip_grad_norm: float) -> Tensor:
        """Clip, update, count the step; returns the norm before clipping."""
        norm = global_norm(grads)
        self.optimizer.update(self.params, clip_by_global_norm(grads, norm, clip_grad_norm),
                              self.opt_state)
        self.step += 1
        return norm


def make_optimizer(cfg: TrainingConfig, steps_per_epoch: int) -> Adam:
    """Adam (AdamW when `weight_decay > 0`) on `make_lr_schedule`; the
    clip by `clip_grad_norm` before it is `TrainState.apply_gradients`'s."""
    return Adam(make_lr_schedule(cfg, steps_per_epoch), cfg.weight_decay)


def create_train_state(cfg: TrainingConfig, model: PosePredictor | None = None, mesh_db: BatchedMeshes | None = None,
                       input_res: tuple[int, int] | None = None,
                       device: str | torch.device = "cuda") -> TrainState:
    """`model` (by default the model of `cfg`) with weights drawn from
    `cfg.seed` (flax's initializers, `PosePredictor.init_weights`; the JAX
    package draws them from its key) on `device`, and a fresh Adam.
    `mesh_db` and `input_res` are not read: the weights' shapes depend on
    neither (the JAX package traces its init on them)."""
    if model is None:
        model = PosePredictor(PosePredictorConfig(**cfg.model_config_kwargs()))
    elif not isinstance(model, torch.nn.Module):
        raise TypeError(f"model must be a PosePredictor, not {type(model).__name__}")
    model.init_weights(torch.Generator().manual_seed(cfg.seed)).to(device).train()
    steps_per_epoch = max(1, cfg.epoch_size // cfg.batch_size)
    return TrainState(step=0, opt_state=Adam.init(list(model.parameters())), model=model,
                      optimizer=make_optimizer(cfg, steps_per_epoch))


def step_draws(cfg: TrainingConfig, batch: BatchPoseData, mesh_db: BatchedMeshes, stream: int,
               index: int, shard: int = 0, rank: int = 0, world: int = 1) -> dict:
    """`forward_loss`'s draws for `batch`, draw `index` of `stream` (of
    label shard `shard`), on the DB's device. With `world > 1`, `batch`
    is rank `rank`'s rows of a global batch `world` times its size, and
    the draws are the global batch's, cut to the same rows."""
    g = step_generator(cfg.seed, stream, index, shard)
    draws = draw_forward_loss(cfg, batch.batch_size * world, mesh_db.points.shape[1], g)
    return draws_to(rank_rows(draws, rank, world), mesh_db.device)


def train_step(
    state: TrainState,
    cfg: TrainingConfig,
    batch: BatchPoseData,
    mesh_db: BatchedMeshes,
    draws: dict,
    n_iterations: int,
    reduce_over=None,
) -> dict[str, float]:
    """forward_loss, backward, clip and Adam; the metrics with the
    gradients' norm before clipping (`grad_norm`). With `reduce_over` (a
    process group), the gradients and metrics are first averaged over its
    ranks, each of which holds its rows of the step's batch (data
    parallel) or its own label shard's batch (label-sharded), and the
    batch-statistics BatchNorms of `zoo_resnet*-train` normalize over all
    the ranks' rows (`synced_batch_stats`)."""
    with synced_batch_stats(state.model, reduce_over):
        loss, metrics = forward_loss(state.model, cfg, batch, mesh_db, n_iterations, draws)
        grads = list(torch.autograd.grad(loss, state.params))
    if reduce_over is not None:
        keys = sorted(metrics)
        reduced = all_reduce_mean(grads + [metrics[k].reshape(1) for k in keys], reduce_over)
        grads = reduced[: len(grads)]
        metrics = {k: v[0] for k, v in zip(keys, reduced[len(grads):])}
    metrics["grad_norm"] = state.apply_gradients(grads, cfg.clip_grad_norm)
    return {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Synthetic batches rendered on the device
# ---------------------------------------------------------------------------


def random_background(coarse: Tensor, fine: Tensor, gain: Tensor, resolution: tuple[int, int]) -> Tensor:
    """Procedural backgrounds `[B, H, W, 3]`: a coarse colour field
    `coarse [B, 6, 8, 3]` in [0, 1] plus a fine one `fine [B, 24, 32, 3]` in
    [-0.15, 0.15], each resized linearly to `resolution` (the JAX
    package's `jax.image.resize(..., "linear")`, through the crop's
    scale-and-translate weights), times `gain [B]`, clipped to [0, 1]."""
    bg = cropping.resize_bilinear(coarse, resolution) + cropping.resize_bilinear(fine, resolution)
    return (bg * gain[:, None, None, None]).clamp(0.0, 1.0)


class SyntheticBatches:
    """Random ground-truth scenes of the DB's objects, rendered through the
    tiled renderer (the CUDA visibility kernel on the card) or the scan
    renderer; see `synthetic_batch_fn`. `draw(generator)` makes a batch's draws on the
    CPU, `make(draws)` renders it from draws on the device, and a call
    does both."""

    def __init__(self, mesh_db: BatchedMeshes, batch_size: int, input_res: tuple[int, int],
                 f: float, domain_rand: bool, occlude: bool, device: str | torch.device,
                 renderer: str = "tiled", face_chunk: int = 64, z_range: tuple[float, float] = (0.35, 0.9)):
        if renderer not in ("tiled", "scan"):
            raise ValueError(f"unknown renderer {renderer!r}")
        self.renderer, self.face_chunk = renderer, face_chunk
        self.z_range = tuple(z_range)  # depth of the object's centre, metres
        self.mesh_db = mesh_db._map(lambda x: x.to(device))
        self.batch_size, self.input_res = batch_size, tuple(input_res)
        self.domain_rand, self.occlude = domain_rand, occlude
        self.device = torch.device(device)
        H, W = self.input_res
        self.K = torch.tensor([[f, 0.0, W / 2 - 0.5], [0.0, f, H / 2 - 0.5], [0.0, 0.0, 1.0]],
                              device=device)
        # A fixed pool of quaternions for cheap random rotations.
        self.quat_pool = torch.as_tensor(super_fibonacci_quats(4096), dtype=torch.float32, device=device)

    def draw(self, generator: torch.Generator) -> dict[str, Tensor]:
        B, L, Q, g = self.batch_size, len(self.mesh_db.labels), len(self.quat_pool), generator
        uniform = lambda shape, lo, hi: torch.rand(shape, generator=g) * (hi - lo) + lo
        d = dict(
            mesh_idx=torch.randint(0, L, (B,), generator=g), quat_idx=torch.randint(0, Q, (B,), generator=g),
            z=uniform((B, 1), *self.z_range), xy=uniform((B, 2), -0.05, 0.05),
        )
        if self.domain_rand:
            d.update(ambient=uniform((B,), 0.5, 1.0), point=uniform((B,), 0.0, 0.5),
                     bg_coarse=uniform((B, 6, 8, 3), 0.0, 1.0), bg_fine=uniform((B, 24, 32, 3), -0.15, 0.15),
                     bg_gain=uniform((B,), 0.4, 1.0))
        if self.occlude:
            # Beside the target (3-9 cm lateral) and 2-12 cm closer.
            lo, hi = torch.tensor([-0.09, -0.09, -0.12]), torch.tensor([0.09, 0.09, -0.02])
            d.update(mesh_idx2=torch.randint(0, L, (B,), generator=g),
                     quat_idx2=torch.randint(0, Q, (B,), generator=g), offset=uniform((B, 3), lo, hi))
        return d

    def _render(self, meshes: BatchedMeshes, TCO: Tensor, light: dict):
        H, W = self.input_res
        K = self.K.expand(TCO.shape[0], 3, 3)
        args = (meshes.vertices, meshes.normals, meshes.colors, meshes.faces, meshes.face_valid, TCO, K, (H, W))
        if self.renderer == "scan":  # two-sided, as the JAX package's scan path
            return rasterizer.render_meshes(*args, chunk=self.face_chunk, **light, **meshes.texture_kw)
        return rasterizer_tiled.render_meshes_tiled(*args, backface_cull=True, **light, **meshes.texture_kw)

    @torch.no_grad()
    def make(self, draws: dict[str, Tensor]) -> BatchPoseData:
        """The batch of `draws` (of `batch_size` samples, or a rank's rows
        of them)."""
        B = draws["z"].shape[0]
        z = draws["z"]
        TCO = make_se3(rotmat_from_quat(self.quat_pool[draws["quat_idx"]]),
                       torch.cat([draws["xy"] * z, z], -1))
        meshes = self.mesh_db.select(draws["mesh_idx"])
        if self.domain_rand:
            light = dict(light_ambient=draws["ambient"], light_point=draws["point"])
        else:
            light = dict(light_ambient=1.0, light_point=0.0)
        out = self._render(meshes, TCO, light)
        rgbs, fg_mask = out.rgb, out.mask
        if self.occlude:
            off = draws["offset"]
            off = torch.cat([off[:, :2] + torch.where(off[:, :2] >= 0, 1.0, -1.0) * 0.03, off[:, 2:]], -1)
            TCO2 = make_se3(rotmat_from_quat(self.quat_pool[draws["quat_idx2"]]), TCO[:, :3, 3] + off)
            out2 = self._render(self.mesh_db.select(draws["mesh_idx2"]), TCO2, light)
            d1 = torch.where(out.mask, out.depth, torch.inf)
            d2 = torch.where(out2.mask, out2.depth, torch.inf)
            occ = out2.mask & (d2 < d1)
            rgbs = torch.where(occ[..., None], out2.rgb, rgbs)
            fg_mask = out.mask | out2.mask
        if self.domain_rand:
            bg = random_background(draws["bg_coarse"], draws["bg_fine"], draws["bg_gain"], self.input_res)
            rgbs = torch.where(fg_mask[..., None], rgbs, bg)
        K = self.K.expand(B, 3, 3)
        uv = project_points_robust(meshes.points, K, TCO)
        bboxes = masked_boxes_from_uv(uv, torch.ones(uv.shape[:2], dtype=torch.bool, device=uv.device))
        return BatchPoseData(rgbs=rgbs, K=K.contiguous(), TCO=TCO, bboxes=bboxes, mesh_idx=draws["mesh_idx"])

    def __call__(self, generator: torch.Generator) -> BatchPoseData:
        return self.make(draws_to(self.draw(generator), self.device))


def synthetic_batch_fn(
    mesh_db: BatchedMeshes,
    batch_size: int,
    input_res: tuple[int, int] = (240, 320),
    f: float = 400.0,
    z_range: tuple[float, float] = (0.35, 0.9),
    face_chunk: int = 64,
    renderer: str | None = None,
    domain_rand: bool = False,
    occlude: bool = False,
    device: str | torch.device = "cuda",
) -> SyntheticBatches:
    """`generator -> BatchPoseData`: random ground-truth scenes of the DB's
    objects on `device`, the objects' centres at depths drawn uniformly in
    `z_range` (metres), rendered unlit on black by the tiled renderer with
    backface culling, or with `renderer="scan"` by the scan renderer
    (two-sided, `face_chunk` faces a step). `renderer=None` is "tiled" on
    every device (the JAX package picks "scan" on a CPU).

    `domain_rand=True` draws each observation's ambient and point light and
    composites a procedural background behind the object. `occlude=True`
    renders a second random object beside and in front of the target and
    keeps its pixels where it is nearer; the pose and box stay the
    target's. Hypothesis renders stay unlit either way."""
    return SyntheticBatches(mesh_db, batch_size, input_res, f, domain_rand, occlude, device,
                            renderer or "tiled", face_chunk, z_range)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(run_dir: str | Path, state: TrainState, epoch: int) -> None:
    """Parameters, buffers (BatchNorm's running statistics), Adam's state
    and the step in `run_dir/checkpoints/epoch_<epoch>/state.pt`;
    `latest.txt` names it."""
    path = Path(run_dir) / "checkpoints" / f"epoch_{epoch}"
    path.mkdir(parents=True, exist_ok=True)
    names = [n for n, _ in state.model.named_parameters()]
    cpu = lambda ts: {n: t.detach().cpu() for n, t in zip(names, ts)}
    torch.save({
        "params": cpu(state.params),
        "buffers": {n: b.detach().cpu() for n, b in state.model.named_buffers()},
        "opt_state": {"count": state.opt_state["count"], "mu": cpu(state.opt_state["mu"]),
                      "nu": cpu(state.opt_state["nu"])},
        "step": state.step,
    }, path / "state.pt")
    (Path(run_dir) / "checkpoints" / "latest.txt").write_text(str(epoch))


def _load_jax_checkpoint(path: Path, state: TrainState, params_only: bool) -> None:
    """Restore a JAX run's orbax checkpoint into `state`: the params, and
    unless `params_only` optax's Adam state (`opt_state[1][0]`: count,
    mu, nu, renamed and transposed as the params are) and the step; a
    params-and-step checkpoint leaves Adam fresh."""
    tree = read_checkpoint(path, prefixes=["params"] if params_only else None)
    device = state.params[0].device
    state.model.load_state_dict({k: v.to(device) for k, v in state_dict_from_jax(tree["params"]).items()})
    if params_only:
        return
    names = [n for n, _ in state.model.named_parameters()]
    if "opt_state" in tree:
        adam = tree["opt_state"][1][0]
        for key in ("mu", "nu"):
            moments = state_dict_from_jax(adam[key])
            for t, n in zip(state.opt_state[key], names):
                t.copy_(moments[n])
        state.opt_state["count"] = int(adam["count"])
    state.step = int(tree["step"])


@torch.no_grad()
def load_checkpoint(run_dir: str | Path, state: TrainState, epoch: int | None = None,
                    params_only: bool = False) -> tuple[TrainState, int]:
    """Restore the checkpoint of `run_dir` at `epoch` (None: the one
    `latest.txt` names) into `state`: a port run's `state.pt` or a JAX
    run's orbax checkpoint (`interop/orbax.py`). `params_only=True` is the
    pretrain path: the weights only, Adam and the step start afresh. A
    checkpoint without Adam's state (one `scripts/slim_run_dir` slimmed, or
    a JAX params-and-step save) restores the weights and the step, with a
    fresh Adam, as the JAX package's params-and-step fallback does."""
    from ..inference.load_model import run_checkpoint

    run_dir = Path(run_dir)
    if epoch is None:
        epoch = int((run_dir / "checkpoints" / "latest.txt").read_text())
    path = run_checkpoint(run_dir, epoch)
    if is_orbax_checkpoint(path):
        _load_jax_checkpoint(path, state, params_only)
        return state, epoch
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict({**saved["params"], **saved.get("buffers", {})})
    names = [n for n, _ in state.model.named_parameters()]
    if not params_only and "opt_state" not in saved:
        state.step = int(saved["step"])
    elif not params_only:
        for key in ("mu", "nu"):
            for t, n in zip(state.opt_state[key], names):
                t.copy_(saved["opt_state"][key][n])
        state.opt_state["count"] = int(saved["opt_state"]["count"])
        state.step = int(saved["step"])
    return state, epoch


@torch.no_grad()
def load_pretrained(path: str | Path, state: TrainState) -> TrainState:
    """Weights only, from a run directory (its latest checkpoint: a JAX
    run's orbax one or a port run's) or from an npz export of a JAX run's
    params."""
    path = Path(path)
    if path.suffix == ".npz":
        from ..inference.load_model import load_params_npz

        sd = state_dict_from_jax(load_params_npz(path))
        state.model.load_state_dict({k: v.to(state.params[0].device) for k, v in sd.items()})
        return state
    return load_checkpoint(path, state, params_only=True)[0]


# ---------------------------------------------------------------------------
# Loop
# ---------------------------------------------------------------------------


def n_iterations_at(cfg: TrainingConfig, epoch: int) -> int:
    """Refiner iterations of an epoch: `n_iterations`, or one more every
    `add_iteration_epoch_interval` epochs up to it."""
    if cfg.add_iteration_epoch_interval > 0:
        return min(epoch // cfg.add_iteration_epoch_interval + 1, cfg.n_iterations)
    return cfg.n_iterations


def batch_source(batches: Callable[[int], BatchPoseData] | Iterator[BatchPoseData], start_step: int,
                 device: torch.device) -> Callable[[int], BatchPoseData]:
    """`step -> batch` on `device`. A callable is used as it is; an
    iterator of host batches (the dataset loader's, pinned on the card)
    gives its batches in turn, each copied with `non_blocking=True`, the
    first `start_step` skipped: the batch of step s is the stream's s-th,
    so a resumed run sees what the unbroken one did."""
    if callable(batches):
        return batches
    stream = iter(batches)
    for _ in range(start_step):
        next(stream)
    return lambda step: next(stream).to(device, non_blocking=True)


def train(
    cfg: TrainingConfig,
    model: PosePredictor | None = None,
    mesh_db: BatchedMeshes | None = None,
    batch_iterator: Callable[[int], BatchPoseData] | Iterator[BatchPoseData] | None = None,
    run_dir: str | Path | None = None,
    n_epochs: int | None = None,
    steps_per_epoch: int | None = None,
    log_fn: Callable[[dict], None] | None = None,
    input_res: tuple[int, int] | None = None,
    val_iterator: Callable[[int, int], BatchPoseData] | Iterator[BatchPoseData] | None = None,
    n_val_batches: int = 4,
    reduce_over=None,
) -> TrainState:
    """Train `model` (by default the model of `cfg`, see
    `create_train_state`) on `batch_iterator` (see `batch_source`) on
    `mesh_db`'s device for `n_epochs` (default `cfg.n_epochs`) epochs of
    `steps_per_epoch` (default `epoch_size // batch_size`) steps:
    per-epoch metric averages as JSON lines in `run_dir/log.txt` (default
    `<cfg.run_dir>/<run_id>`), also passed to `log_fn`, the iteration ramp,
    validation every `val_epoch_interval` epochs on `n_val_batches` batches
    of `val_iterator` (forward loss only; an iterator, or a callable
    `(epoch, i) -> batch`; none without it), checkpoints every
    `save_epoch_interval` epochs and at the end. `resume_run_id` restores
    parameters, Adam and the step and continues at the saved epoch + 1;
    `pretrain_run_id` restores the weights only (a JAX or port run, or an npz,
    under `cfg.run_dir`).

    Data parallel with `reduce_over` (a process group of W ranks, each
    with the same `cfg`; the JAX package's `device_mesh`): `batch_iterator`
    gives rank r its `batch_size / W` samples of each step (its rows of the
    global batch, or its own loader's batch), and the rank takes the same
    rows of the step's draws; every rank restores a resumed run; the
    epoch's metrics go through `reduce_dict`, and only rank 0 writes
    `config.json`, `log.txt` and checkpoints."""
    rank, world = (0, 1) if reduce_over is None else (dist.get_rank(reduce_over), dist.get_world_size(reduce_over))
    if cfg.batch_size % world:
        raise ValueError(f"batch_size {cfg.batch_size} does not split over {world} ranks")
    if mesh_db is None or batch_iterator is None:
        raise ValueError("train needs a mesh_db and a batch_iterator")
    run_dir = Path(run_dir or Path(cfg.run_dir) / cfg.run_id)
    if rank == 0:
        run_dir.mkdir(parents=True, exist_ok=True)
        save_config(cfg, run_dir / "config.json")
    state = create_train_state(cfg, model, mesh_db, input_res, device=mesh_db.device)
    start_epoch = 1
    if cfg.resume_run_id:
        state, ckpt_epoch = load_checkpoint(Path(cfg.run_dir) / cfg.resume_run_id, state)
        start_epoch = ckpt_epoch + 1
    elif cfg.pretrain_run_id:
        state = load_pretrained(Path(cfg.run_dir) / cfg.pretrain_run_id, state)

    n_epochs = n_epochs or cfg.n_epochs
    steps_per_epoch = steps_per_epoch or max(1, cfg.epoch_size // cfg.batch_size)
    batch_at = batch_source(batch_iterator, state.step, mesh_db.device)
    val_at = None
    if val_iterator is not None:
        val_at = val_iterator if callable(val_iterator) else (
            lambda epoch, i, stream=iter(val_iterator): next(stream).to(mesh_db.device, non_blocking=True))
    for epoch in range(start_epoch, n_epochs + 1):
        n_iter = n_iterations_at(cfg, epoch)
        sums: dict[str, float] = {}
        t0 = time.monotonic()
        for _ in range(steps_per_epoch):
            batch = batch_at(state.step)
            draws = step_draws(cfg, batch, mesh_db, DRAW_STREAM, state.step, rank=rank, world=world)
            metrics = train_step(state, cfg, batch, mesh_db, draws, n_iter, reduce_over)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        log = {k: v / steps_per_epoch for k, v in sums.items()}
        log.update(epoch=epoch, n_iterations=n_iter, time_per_epoch=time.monotonic() - t0)
        if val_at is not None and epoch % max(1, cfg.val_epoch_interval) == 0:
            val_losses = []
            with torch.no_grad(), synced_batch_stats(state.model, reduce_over):
                for i in range(n_val_batches):
                    vb = val_at(epoch, i)
                    draws = step_draws(cfg, vb, mesh_db, VAL_DRAW_STREAM, (epoch << 8) + i, rank=rank,
                                       world=world)
                    val_losses.append(float(forward_loss(state.model, cfg, vb, mesh_db, n_iter, draws)[0]))
            log["val_loss"] = sum(val_losses) / len(val_losses)
        if world > 1:
            from ..parallel.distributed import reduce_dict  # here: parallel.distributed imports data, data training

            reduced = reduce_dict(log, group=reduce_over)
            log = {**{k: reduced[k] for k in log}, "epoch": epoch, "n_iterations": n_iter}
        if rank != 0:
            continue
        with open(run_dir / "log.txt", "a") as fh:
            fh.write(json.dumps(log) + "\n")
        if log_fn:
            log_fn(log)
        if epoch % cfg.save_epoch_interval == 0 or epoch == n_epochs:
            save_checkpoint(run_dir, state, epoch)
    return state
