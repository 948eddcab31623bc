"""Training: the optimizer and its schedule, the train step, synthetic
batches rendered on the device, checkpoints and the loop.

Counterpart of `megapose6d_tpu/training/train.py` on one device:
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
    `torch.save` in place of orbax (`epoch_N/state.pt`).
The JAX package's data-parallel step over a device mesh is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Iterator

import torch

from ..interop.from_jax import state_dict_from_jax
from ..meshes.mesh_db import BatchedMeshes
from ..models.pose_predictor import PosePredictor, PosePredictorConfig
from ..ops import cropping, rasterizer_tiled
from ..ops.camera import masked_boxes_from_uv, project_points_robust
from ..ops.se3 import make_se3, rotmat_from_quat
from ..ops.so3_grid import super_fibonacci_quats
from .config import TrainingConfig, save_config
from .forward_loss import BatchPoseData, draw_forward_loss, draws_to, forward_loss

Tensor = torch.Tensor

# Streams of `step_generator`.
DRAW_STREAM, BATCH_STREAM, VAL_DRAW_STREAM, VAL_BATCH_STREAM = 0, 1, 2, 3
# Validation batches per validation epoch.
N_VAL_BATCHES = 2


def step_generator(seed: int, stream: int, index: int) -> torch.Generator:
    """A CPU generator for draw `index` (a step, or a validation batch) of
    `stream`, a function of (seed, stream, index) only."""
    return torch.Generator().manual_seed(((seed & 0xFFFFF) << 40) | ((stream & 0xFF) << 32)
                                         | (index & 0xFFFFFFFF))


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
    """The model (float32 parameters), Adam's state and the step."""

    model: PosePredictor
    optimizer: Adam
    opt_state: dict
    step: int = 0

    @property
    def params(self) -> list[Tensor]:
        return list(self.model.parameters())

    def apply_gradients(self, grads: list[Tensor], clip_grad_norm: float) -> Tensor:
        """Clip, update, count the step; returns the norm before clipping."""
        norm = global_norm(grads)
        self.optimizer.update(self.params, clip_by_global_norm(grads, norm, clip_grad_norm),
                              self.opt_state)
        self.step += 1
        return norm


def create_train_state(cfg: TrainingConfig, device: str | torch.device = "cuda") -> TrainState:
    """The model of `cfg` with weights drawn from `cfg.seed` (flax's
    initializers, `PosePredictor.init_weights`) and a fresh Adam."""
    model = PosePredictor(PosePredictorConfig(**cfg.model_config_kwargs()))
    model.init_weights(torch.Generator().manual_seed(cfg.seed)).to(device).train()
    steps_per_epoch = max(1, cfg.epoch_size // cfg.batch_size)
    optimizer = Adam(make_lr_schedule(cfg, steps_per_epoch), cfg.weight_decay)
    return TrainState(model, optimizer, Adam.init(list(model.parameters())))


def step_draws(cfg: TrainingConfig, batch: BatchPoseData, mesh_db: BatchedMeshes, stream: int,
               index: int) -> dict:
    """`forward_loss`'s draws for `batch`, draw `index` of `stream`, on
    the DB's device."""
    g = step_generator(cfg.seed, stream, index)
    return draws_to(draw_forward_loss(cfg, batch.batch_size, mesh_db.points.shape[1], g), mesh_db.device)


def train_step(
    state: TrainState,
    cfg: TrainingConfig,
    batch: BatchPoseData,
    mesh_db: BatchedMeshes,
    draws: dict,
    n_iterations: int,
) -> dict[str, float]:
    """forward_loss, backward, clip and Adam; the metrics with the
    gradients' norm before clipping (`grad_norm`)."""
    loss, metrics = forward_loss(state.model, cfg, batch, mesh_db, draws, n_iterations)
    grads = torch.autograd.grad(loss, state.params)
    metrics["grad_norm"] = state.apply_gradients(list(grads), cfg.clip_grad_norm)
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
    tiled renderer (the CUDA visibility kernel on the card); see
    `synthetic_batch_fn`. `draw(generator)` makes a batch's draws on the
    CPU, `make(draws)` renders it from draws on the device, and a call
    does both."""

    z_range = (0.35, 0.9)  # depth of the object's centre, metres

    def __init__(self, mesh_db: BatchedMeshes, batch_size: int, input_res: tuple[int, int],
                 f: float, domain_rand: bool, occlude: bool, device: str | torch.device):
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
        return rasterizer_tiled.render_meshes_tiled(
            meshes.vertices, meshes.normals, meshes.colors, meshes.faces, meshes.face_valid,
            TCO, K, (H, W), backface_cull=True, **light, **meshes.texture_kw,
        )

    @torch.no_grad()
    def make(self, draws: dict[str, Tensor]) -> BatchPoseData:
        B = self.batch_size
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
    domain_rand: bool = False,
    occlude: bool = False,
    device: str | torch.device = "cuda",
) -> SyntheticBatches:
    """`generator -> BatchPoseData`: random ground-truth scenes of the DB's
    objects on `device`, rendered with backface culling, unlit, on black.

    `domain_rand=True` draws each observation's ambient and point light and
    composites a procedural background behind the object. `occlude=True`
    renders a second random object beside and in front of the target and
    keeps its pixels where it is nearer; the pose and box stay the
    target's. Hypothesis renders stay unlit either way."""
    return SyntheticBatches(mesh_db, batch_size, input_res, f, domain_rand, occlude, device)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(run_dir: str | Path, state: TrainState, epoch: int) -> None:
    """Parameters, Adam's state and the step in
    `run_dir/checkpoints/epoch_<epoch>/state.pt`; `latest.txt` names it."""
    path = Path(run_dir) / "checkpoints" / f"epoch_{epoch}"
    path.mkdir(parents=True, exist_ok=True)
    names = [n for n, _ in state.model.named_parameters()]
    cpu = lambda ts: {n: t.detach().cpu() for n, t in zip(names, ts)}
    torch.save({
        "params": cpu(state.params),
        "opt_state": {"count": state.opt_state["count"], "mu": cpu(state.opt_state["mu"]),
                      "nu": cpu(state.opt_state["nu"])},
        "step": state.step,
    }, path / "state.pt")
    (Path(run_dir) / "checkpoints" / "latest.txt").write_text(str(epoch))


@torch.no_grad()
def load_checkpoint(run_dir: str | Path, state: TrainState, params_only: bool = False) -> tuple[TrainState, int]:
    """Restore the checkpoint of `run_dir` that `latest.txt` names into
    `state`. `params_only=True` is the pretrain path: the weights only,
    Adam and the step start afresh."""
    run_dir = Path(run_dir)
    epoch = int((run_dir / "checkpoints" / "latest.txt").read_text())
    saved = torch.load(run_dir / "checkpoints" / f"epoch_{epoch}" / "state.pt", map_location="cpu",
                       weights_only=True)
    state.model.load_state_dict(saved["params"])
    names = [n for n, _ in state.model.named_parameters()]
    if not params_only:
        for key in ("mu", "nu"):
            for t, n in zip(state.opt_state[key], names):
                t.copy_(saved["opt_state"][key][n])
        state.opt_state["count"] = int(saved["opt_state"]["count"])
        state.step = int(saved["step"])
    return state, epoch


@torch.no_grad()
def load_pretrained(path: str | Path, state: TrainState) -> TrainState:
    """Weights only, from a port run directory (its latest checkpoint) or
    from an npz export of a JAX run's params (`python -m
    tests.test_torch_checkpoints export <run> <out.npz>`)."""
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
    mesh_db: BatchedMeshes,
    batches: Callable[[int], BatchPoseData] | Iterator[BatchPoseData],
    val_batches: Callable[[int, int], BatchPoseData] | None,
    log_fn: Callable[[dict], None],
) -> TrainState:
    """Train on `batches` (see `batch_source`) on `mesh_db`'s device for
    `cfg.n_epochs` epochs of `epoch_size // batch_size` steps: per-epoch
    metric averages as JSON lines in `<run_dir>/<run_id>/log.txt`, also
    passed to `log_fn`, the iteration ramp, validation every
    `val_epoch_interval` epochs on `val_batches(epoch, i)` for
    `N_VAL_BATCHES` batches (forward loss only; none without
    `val_batches`, as on the dataset path), checkpoints every
    `save_epoch_interval` epochs and at the end. `resume_run_id` restores
    parameters, Adam and the step and continues at the saved epoch + 1;
    `pretrain_run_id` restores the weights only (a port run or an npz,
    under `run_dir`)."""
    run_dir = Path(cfg.run_dir) / cfg.run_id
    run_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, run_dir / "config.json")
    state = create_train_state(cfg, device=mesh_db.device)
    start_epoch = 1
    if cfg.resume_run_id:
        state, ckpt_epoch = load_checkpoint(Path(cfg.run_dir) / cfg.resume_run_id, state)
        start_epoch = ckpt_epoch + 1
    elif cfg.pretrain_run_id:
        state = load_pretrained(Path(cfg.run_dir) / cfg.pretrain_run_id, state)

    steps_per_epoch = max(1, cfg.epoch_size // cfg.batch_size)
    batch_at = batch_source(batches, state.step, mesh_db.device)
    for epoch in range(start_epoch, cfg.n_epochs + 1):
        n_iter = n_iterations_at(cfg, epoch)
        sums: dict[str, float] = {}
        t0 = time.monotonic()
        for _ in range(steps_per_epoch):
            batch = batch_at(state.step)
            draws = step_draws(cfg, batch, mesh_db, DRAW_STREAM, state.step)
            metrics = train_step(state, cfg, batch, mesh_db, draws, n_iter)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        log = {k: v / steps_per_epoch for k, v in sums.items()}
        log.update(epoch=epoch, n_iterations=n_iter, time_per_epoch=time.monotonic() - t0)
        if val_batches is not None and epoch % max(1, cfg.val_epoch_interval) == 0:
            val_losses = []
            with torch.no_grad():
                for i in range(N_VAL_BATCHES):
                    vb = val_batches(epoch, i)
                    draws = step_draws(cfg, vb, mesh_db, VAL_DRAW_STREAM, (epoch << 8) + i)
                    val_losses.append(float(forward_loss(state.model, cfg, vb, mesh_db, draws, n_iter)[0]))
            log["val_loss"] = sum(val_losses) / len(val_losses)
        with open(run_dir / "log.txt", "a") as fh:
            fh.write(json.dumps(log) + "\n")
        log_fn(log)
        if epoch % cfg.save_epoch_interval == 0 or epoch == cfg.n_epochs:
            save_checkpoint(run_dir, state, epoch)
    return state
