"""PoseEstimator: the public inference pipeline.

Counterpart of `PoseEstimator.run_inference_pipeline` in
`megapose6d_tpu/inference/pose_estimator.py`:

  detections -> coarse scores of every (detection, SO(3)-grid rotation)
  hypothesis -> top-K -> K x N refiner iterations -> coarse re-scoring
  -> top-1 per detection -> optionally, depth refinement of the top-1
  poses (`inference/depth_refiner.py`).

With the JAX package's options:
  - hierarchical coarse scoring (`SO3_prune_grid_size`, `SO3_prune_keep`):
    a probe grid first, then only the Voronoi children of its best
    rotations, which stay members of the full grid;
  - a coarse LOD mesh database (`mesh_db_coarse`) for the sweep and the
    rescore, while the refiner renders `mesh_db`;
  - the sweep's renders rasterised at `coarse_render_size` and upsampled
    (a twin of the coarse model with `render_at`), and the rescore in
    float32 (`rescore_f32`, a float32 twin); twins share the coarse
    model's parameter tensors;
  - the fused mode (`fused_pipeline`): detections padded to
    `max_detections` and the whole pipeline with no host synchronisation
    between phases; on the GPU it is captured once per shape into a CUDA
    graph and replayed per request, on the CPU it runs eagerly;
  - external initial poses (`coarse_estimation_type="external"`): the
    detections' `TCO_init` refined and rescored, the coarse stage skipped.

  - the sharded mode (`device_mesh`, a list of devices, as
    `parallel.mesh.make_mesh` gives): the coarse sweep (the probe and
    children sweeps when pruned), the refiner and the rescore each split
    their hypotheses over the list, as the JAX package's `shard_map` does
    over its mesh axis. The hypotheses are padded with identity poses of
    mesh 0 to `ceil(N / (n_dev * chunk)) * chunk` per device, with the
    chunk `min(chunk, ceil(N / n_dev))`; each device holds a replica of
    the models and mesh databases (one per distinct device); the results
    are gathered on the first device, the estimator's. The fused mode is
    off under a mesh.

Detections are given, or come from the estimator's `detector`
(`run_inference_pipeline(run_detector=True)`); in the fused mode the
detector runs before the graph. The phased mode keeps the detections
unpadded and the chunks as they fall (the last one shorter); every
hypothesis is computed independently, so the results depend on the
chunking or the sharding only through float32 rounding: the convolutions
may sum in another order at another batch size, and a randomly
initialised refiner amplifies such a last-bit difference over its
iterations (ROADMAP Queue 3). At equal chunks the sharded mode repeats
the unsharded launches. A depth stage asked for without a depth refiner
raises (the JAX package silently skips it).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..data.tensor_collection import TensorCollection
from ..data.types import ObservationTensor
from ..meshes.mesh_db import BatchedMeshes
from ..models.pose_predictor import PosePredictor
from ..ops._precision import pin_f32
from ..ops.pose_init import tco_init_from_boxes_autodepth_with_R
from ..ops.so3_grid import build_prune_table, make_so3_grid
from .depth_refiner import DepthRefiner
from .types import InferenceConfig

Tensor = torch.Tensor


def _top_k(x: Tensor, k: int) -> Tensor:
    """Indices of the `k` largest entries of each row, ties to the lower
    index (as `jax.lax.top_k`)."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]


def _pad_rows(x: Tensor, n: int) -> Tensor:
    """`x` padded to `n` rows by repeating its last row (numpy's "edge")."""
    return torch.cat([x, x[-1:].expand((n - x.shape[0],) + x.shape[1:])]) if n > x.shape[0] else x[:n]


@dataclasses.dataclass
class _Replica:
    """The models and mesh databases that one device of a mesh computes
    with."""

    device: torch.device
    coarse_sweep: PosePredictor
    coarse_rescore: PosePredictor
    refiner: PosePredictor
    mesh_db: BatchedMeshes
    mesh_db_coarse: BatchedMeshes

    def to(self, device: torch.device) -> "_Replica":
        """A copy on `device`; the coarse twins keep sharing one copy of
        the parameters."""
        coarse = copy.deepcopy(self.coarse_sweep).to(device)
        twin = lambda m: coarse.twin(compute_dtype=m.cfg.compute_dtype, render_at=m.cfg.render_at)  # noqa: E731
        db = self.mesh_db._map(lambda x: x.to(device))
        db_coarse = db if self.mesh_db_coarse is self.mesh_db else self.mesh_db_coarse._map(lambda x: x.to(device))
        return _Replica(device, coarse, twin(self.coarse_rescore), copy.deepcopy(self.refiner).to(device), db,
                        db_coarse)


class _GraphedPipeline:
    """One capture of the fused pipeline into a CUDA graph, replayed per
    request. A request copies its inputs into the static ones; the outputs
    are the static tensors the replay overwrites. `kernel_launches` is the
    number of visibility kernel launches recorded in the graph, which every
    replay launches again."""

    def __init__(self, fn, inputs: tuple[Tensor, ...]):
        from ..ops import rasterizer_tiled as rt

        rt.visibility_kernel.library()  # built before the capture
        self.inputs = tuple(x.clone() for x in inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up: library handles, workspaces
            fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = rt.visibility_kernel.launches
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)
        self.kernel_launches = rt.visibility_kernel.launches - before
        self.replays = 0

    def __call__(self, *inputs: Tensor) -> dict[str, Tensor]:
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        self.replays += 1
        return self.outputs


class PoseEstimator:
    """Coarse + refiner orchestration over one observation.

    Args:
      coarse_model / refiner_model: `PosePredictor`s (weights loaded).
      mesh_db: padded `BatchedMeshes` covering all labels in play.
      cfg: `InferenceConfig`.
      device: where the models, meshes and work live.
      depth_refiner: a `DepthRefiner` on the same mesh database, for
        `run_depth_refiner`.
      mesh_db_coarse: a database of the same labels with fewer faces, for
        the coarse sweep and the rescore (default: `mesh_db`).
      detector: a `models.detector.Detector` for `run_detector=True`.
      device_mesh: devices to split the hypotheses over (the sharded
        mode); the first must be `device`. A device may repeat.
    """

    def __init__(
        self,
        coarse_model: PosePredictor,
        refiner_model: PosePredictor,
        mesh_db: BatchedMeshes,
        cfg: InferenceConfig = InferenceConfig(),
        device: str | torch.device = "cuda",
        depth_refiner: DepthRefiner | None = None,
        mesh_db_coarse: BatchedMeshes | None = None,
        detector=None,
        device_mesh: Sequence[torch.device | str] | None = None,
    ):
        if cfg.run_depth_refiner and depth_refiner is None:
            raise ValueError("run_depth_refiner needs a depth_refiner")
        pin_f32()
        self.device = self._normalize(device)
        self.coarse_model = coarse_model.to(self.device).eval()
        self.refiner_model = refiner_model.to(self.device).eval()
        self.detector = detector
        ccfg = self.coarse_model.cfg
        # Twins of the coarse model (same parameter tensors): the sweep's at
        # a lower raster resolution, the rescore's in float32.
        self.coarse_model_sweep = self.coarse_model
        if cfg.coarse_render_size and tuple(cfg.coarse_render_size) != tuple(ccfg.render_size):
            self.coarse_model_sweep = self.coarse_model.twin(render_at=tuple(cfg.coarse_render_size))
        self.coarse_model_rescore = self.coarse_model
        if cfg.rescore_f32 and ccfg.compute_dtype != "float32":
            self.coarse_model_rescore = self.coarse_model.twin(compute_dtype="float32")
        self.mesh_db = mesh_db
        self.mesh_db_coarse = mesh_db if mesh_db_coarse is None else mesh_db_coarse
        for db in (self.mesh_db, self.mesh_db_coarse):
            if db.device != self.device:
                raise ValueError(f"a mesh database is on {db.device}, the estimator on {self.device}")
        if self.mesh_db_coarse.labels != mesh_db.labels:
            raise ValueError("mesh_db_coarse must hold the labels of mesh_db, in the same order")
        self.cfg = cfg
        self.depth_refiner = depth_refiner
        self.so3_grid = make_so3_grid(cfg.SO3_grid_size, device=self.device)
        if cfg.SO3_prune_grid_size:
            self.so3_prune_grid = make_so3_grid(cfg.SO3_prune_grid_size, device=self.device)
            children, valid = build_prune_table(self.so3_grid, self.so3_prune_grid)
            self.prune_children = torch.as_tensor(children, dtype=torch.long, device=self.device)
            self.prune_child_valid = torch.as_tensor(valid, device=self.device)
        self.timing_: dict[str, float] = {}
        self._graphs: dict[tuple, _GraphedPipeline] = {}
        self.device_mesh = None
        if device_mesh is not None:
            self.device_mesh = [self._normalize(d) for d in device_mesh]
            if self.device_mesh[0] != self.device:
                raise ValueError(f"the mesh's first device {self.device_mesh[0]} is not the estimator's {self.device}")
            local = _Replica(self.device, self.coarse_model_sweep, self.coarse_model_rescore, self.refiner_model,
                             self.mesh_db, self.mesh_db_coarse)
            replicas = {self.device: local}
            for d in self.device_mesh:
                if d not in replicas:
                    replicas[d] = local.to(d)
            self._replicas = [replicas[d] for d in self.device_mesh]

    @staticmethod
    def _normalize(device: torch.device | str) -> torch.device:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    def _clock(self) -> float:
        """Host time after the device has finished the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def _score(
        self, model: PosePredictor, mesh_db: BatchedMeshes, chunk: int, images: Tensor, K: Tensor,
        TCO: Tensor, mesh_idx: Tensor,
    ) -> Tensor:
        """Logits `[N]` of `model` for poses `TCO [N, 4, 4]` of the meshes
        `mesh_idx [N]` of `mesh_db`, `chunk` at a time."""
        logits = []
        for s in range(0, TCO.shape[0], chunk):
            T_c = TCO[s : s + chunk]
            out = model.score_views(
                images, K.expand(T_c.shape[0], 3, 3), T_c, mesh_db.select(mesh_idx[s : s + chunk]),
            )
            logits.append(out["logits"][:, 0])
        return torch.cat(logits)

    def init_hypotheses(self, K: Tensor, boxes: Tensor, mesh_idx: Tensor, grid: Tensor) -> Tensor:
        """TCO_init `[D, M, 4, 4]` from the boxes `[D, 4]` and the rotations
        `grid`, `[M, 3, 3]` shared or `[D, M, 3, 3]` per detection."""
        D, M = boxes.shape[0], grid.shape[-3]
        points = self.mesh_db.points[mesh_idx]  # [D, P, 3]
        return tco_init_from_boxes_autodepth_with_R(
            boxes[:, None].expand(D, M, 4).reshape(D * M, 4),
            points[:, None].expand((D, M) + points.shape[1:]).reshape((D * M,) + points.shape[1:]),
            K.expand(D * M, 3, 3),
            grid.expand(D, M, 3, 3).reshape(D * M, 3, 3),
        ).reshape(D, M, 4, 4)

    def coarse_logits(
        self, chunk: int, images: Tensor, K: Tensor, boxes: Tensor, mesh_idx: Tensor,
        grid: Tensor | None = None,
    ) -> tuple[Tensor, Tensor]:
        """Score every (detection, rotation) hypothesis of `grid` (default:
        the SO(3) grid) with the sweep's model and mesh database.

        Returns (logits `[D, M]`, TCO_init `[D, M, 4, 4]`)."""
        grid = self.so3_grid if grid is None else grid
        TCO_init = self.init_hypotheses(K, boxes, mesh_idx, grid)
        D, M = TCO_init.shape[:2]
        logits = self._scores("coarse_sweep", chunk, images, K, TCO_init.reshape(D * M, 4, 4),
                              mesh_idx.repeat_interleave(M))
        return logits.reshape(D, M), TCO_init

    def prune_candidates(self, probe_logits: Tensor) -> tuple[Tensor, Tensor]:
        """Probe scores `[D, M1]` -> (grid ids `[D, P*C]`, valid `[D, P*C]`):
        the Voronoi children of the `SO3_prune_keep` best parents."""
        P = min(self.cfg.SO3_prune_keep, self.so3_prune_grid.shape[0])
        parents = _top_k(probe_logits, P)
        D = probe_logits.shape[0]
        return self.prune_children[parents].reshape(D, -1), self.prune_child_valid[parents].reshape(D, -1)

    def coarse_stage(
        self, chunk: int, images: Tensor, K: Tensor, boxes: Tensor, mesh_idx: Tensor
    ) -> tuple[Tensor, Tensor]:
        """The SO(3) grid's sweep, or with `SO3_prune_grid_size` the probe
        grid's followed by the children of its best rotations (padded
        child slots score -inf). Returns (logits `[D, Mc]`, TCO_init
        `[D, Mc, 4, 4]`)."""
        if not self.cfg.SO3_prune_grid_size:
            return self.coarse_logits(chunk, images, K, boxes, mesh_idx)
        D = boxes.shape[0]
        probe = self.so3_prune_grid
        logits1, _ = self.coarse_logits(min(chunk, D * probe.shape[0]), images, K, boxes, mesh_idx, probe)
        cand, valid = self.prune_candidates(logits1)
        logits2, TCO_init = self.coarse_logits(
            min(chunk, D * cand.shape[1]), images, K, boxes, mesh_idx, self.so3_grid[cand])
        return torch.where(valid, logits2, float("-inf")), TCO_init

    @staticmethod
    def _refine(refiner: PosePredictor, mesh_db: BatchedMeshes, chunk: int, n_iterations: int, images: Tensor,
                K: Tensor, TCO: Tensor, mesh_idx: Tensor) -> tuple[Tensor, Tensor]:
        finals, trajs = [], []
        for s in range(0, TCO.shape[0], chunk):
            T = TCO[s : s + chunk]
            meshes = mesh_db.select(mesh_idx[s : s + chunk])
            K_c = K.expand(T.shape[0], 3, 3)
            traj = []
            for _ in range(n_iterations):
                T = refiner.refine_step(images, K_c, T, meshes)["TCO_output"]
                traj.append(T)
            finals.append(T)
            trajs.append(torch.stack(traj))
        return torch.cat(finals), torch.cat(trajs, dim=1)

    def _shards(self, chunk: int, TCO: Tensor, mesh_idx: Tensor) -> tuple[int, list]:
        """The sharded mode's split of `N` hypotheses: the chunk
        `min(chunk, ceil(N / n_dev))`, and per device of the mesh its
        replica and its `ceil(N / (n_dev * chunk)) * chunk` poses and mesh
        indices, padded with identity poses of mesh 0, on its device."""
        n_dev, N = len(self._replicas), TCO.shape[0]
        chunk = min(chunk, -(-N // n_dev))
        per_dev = -(-N // (n_dev * chunk)) * chunk
        n_pad = per_dev * n_dev - N
        TCO = torch.cat([TCO, torch.eye(4, dtype=TCO.dtype, device=TCO.device).expand(n_pad, 4, 4)])
        mesh_idx = torch.cat([mesh_idx, mesh_idx.new_zeros(n_pad)])
        rows = [slice(i * per_dev, (i + 1) * per_dev) for i in range(n_dev)]
        return chunk, [(rep, TCO[r].to(rep.device), mesh_idx[r].to(rep.device)) for rep, r in zip(self._replicas, rows)]

    def _scores(self, model: str, chunk: int, images: Tensor, K: Tensor, TCO: Tensor, mesh_idx: Tensor) -> Tensor:
        """Logits `[N]` of the coarse model `model` ("coarse_sweep" or
        "coarse_rescore") on the coarse mesh database; in the sharded mode
        split over the mesh and gathered on the first device."""
        if self.device_mesh is None:
            models = {"coarse_sweep": self.coarse_model_sweep, "coarse_rescore": self.coarse_model_rescore}
            return self._score(models[model], self.mesh_db_coarse, chunk, images, K, TCO, mesh_idx)
        chunk, shards = self._shards(chunk, TCO, mesh_idx)
        out = [self._score(getattr(rep, model), rep.mesh_db_coarse, chunk, images.to(rep.device),
                           K.to(rep.device), T, idx) for rep, T, idx in shards]
        return torch.cat([o.to(self.device) for o in out])[: TCO.shape[0]]

    def refine(
        self, chunk: int, n_iterations: int, images: Tensor, K: Tensor, TCO: Tensor,
        mesh_idx: Tensor,
    ) -> tuple[Tensor, Tensor]:
        """Run the refiner on `TCO [N, 4, 4]`, `chunk` hypotheses at a time
        (in the sharded mode split over the mesh, gathered on the first
        device).

        Returns (TCO_refined `[N, 4, 4]`, trajectory `[n_iter, N, 4, 4]`)."""
        if self.device_mesh is None:
            return self._refine(self.refiner_model, self.mesh_db, chunk, n_iterations, images, K, TCO, mesh_idx)
        N = TCO.shape[0]
        chunk, shards = self._shards(chunk, TCO, mesh_idx)
        out = [self._refine(rep.refiner, rep.mesh_db, chunk, n_iterations, images.to(rep.device),
                            K.to(rep.device), T, idx) for rep, T, idx in shards]
        return (torch.cat([f.to(self.device) for f, _ in out])[:N],
                torch.cat([t.to(self.device) for _, t in out], dim=1)[:, :N])

    def rescore(self, chunk: int, images: Tensor, K: Tensor, TCO: Tensor, mesh_idx: Tensor) -> Tensor:
        """Coarse logits `[N]` of refined poses, with the rescore's model
        and the coarse mesh database."""
        return self._scores("coarse_rescore", chunk, images, K, TCO, mesh_idx)

    def pipeline(
        self, chunk_images: int, chunk_objects: int, n_iterations: int, top_k: int,
        images: Tensor, K: Tensor, boxes: Tensor, mesh_idx: Tensor,
        timing: dict[str, float] | None = None,
    ) -> dict[str, Tensor]:
        """coarse -> top-K -> refiner -> rescore -> top-1 on `D` detections.
        With `timing`, each phase is clocked into it (the phased mode);
        without, nothing waits for the device (the fused mode, which a CUDA
        graph can capture)."""
        clock = self._clock if timing is not None else lambda: 0.0
        D = boxes.shape[0]
        t0 = clock()
        logits, TCO_init = self.coarse_stage(chunk_images, images, K, boxes, mesh_idx)
        t1 = clock()
        top_ids = _top_k(logits, top_k)
        TCO_topk = torch.gather(TCO_init, 1, top_ids[..., None, None].expand(-1, -1, 4, 4))
        N = D * top_k
        idx_flat = mesh_idx.repeat_interleave(top_k)
        chunk_r = min(chunk_objects, N)
        TCO_refined, traj = self.refine(chunk_r, n_iterations, images, K, TCO_topk.reshape(N, 4, 4), idx_flat)
        t2 = clock()
        pose_logits = self.rescore(chunk_r, images, K, TCO_refined, idx_flat).reshape(D, top_k)
        if timing is not None:
            timing.update(coarse=t1 - t0, refiner=t2 - t1, scoring=clock() - t2)
        best = pose_logits.argmax(dim=1)
        rows = torch.arange(D, device=boxes.device)
        return {
            "TCO_best": TCO_refined.reshape(D, top_k, 4, 4)[rows, best],
            "best_logit": pose_logits[rows, best],
            "logits": logits, "TCO_init": TCO_init, "top_ids": top_ids,
            "traj": traj.reshape(n_iterations, D, top_k, 4, 4),
            "TCO_refined": TCO_refined.reshape(D, top_k, 4, 4), "pose_logits_dk": pose_logits,
        }

    def fused_inputs(
        self, images: Tensor, K: Tensor, boxes: Tensor, mesh_idx: Tensor, n_iterations: int, top_k: int
    ) -> tuple[tuple[int, ...], tuple[Tensor, ...]]:
        """The fused mode's arguments for `D <= max_detections` detections:
        the chunk sizes, iterations and top-K, and the tensors with the
        detections padded to `max_detections` by repeating the last."""
        D = self.cfg.max_detections
        args = (min(self.cfg.bsz_images, D * self.so3_grid.shape[0]), self.cfg.bsz_objects, n_iterations, top_k)
        return args, (images, K, _pad_rows(boxes, D), _pad_rows(mesh_idx, D))

    def fused(
        self, chunk_images: int, chunk_objects: int, n_iterations: int, top_k: int,
        images: Tensor, K: Tensor, boxes: Tensor, mesh_idx: Tensor,
    ) -> dict[str, Tensor]:
        """`pipeline` as one program: on the GPU a CUDA graph, captured at
        the first request of its shapes and replayed after (the returned
        tensors are the graph's and the next replay overwrites them); on
        the CPU an eager run. A failed capture raises."""
        args = (chunk_images, chunk_objects, n_iterations, top_k)
        inputs = (images, K, boxes, mesh_idx)
        if self.device.type != "cuda":
            return self.pipeline(*args, *inputs)
        key = args + tuple((tuple(x.shape), x.dtype) for x in inputs) + (
            self.cfg, id(self.coarse_model_sweep), id(self.coarse_model_rescore), id(self.refiner_model),
            id(self.mesh_db), id(self.mesh_db_coarse))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _GraphedPipeline(lambda *xs: self.pipeline(*args, *xs), inputs)
        return graph(*inputs)

    # ------------------------------------------------------------------
    # FLOPs
    # ------------------------------------------------------------------

    @staticmethod
    def _count_flops(fn, *args) -> tuple[int, dict[str, int]]:
        """FLOPs of one real call of `fn(*args)` as `FlopCounterMode` counts
        them (matmuls and convolutions), and its per-operator totals."""
        from torch.utils.flop_counter import FlopCounterMode

        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            fn(*args)
        return counter.get_total_flops(), {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}

    @staticmethod
    def _chunks(n: int, chunk: int) -> list[tuple[int, int]]:
        """(rows, trips) of the calls that `n` hypotheses take `chunk` at a
        time: the full chunks, then the shorter last one."""
        full, rest = divmod(n, chunk)
        return [(chunk, full)] + ([(rest, 1)] if rest else [])

    def fused_pipeline_cost_analysis(self, observation: ObservationTensor, detections: TensorCollection) -> dict:
        """The FLOPs of one call of the fused pipeline on `observation`
        and `detections` padded to `max_detections`: `pipeline`, the
        function the fused mode captures, run once eagerly on the
        estimator's device under `FlopCounterMode`, every chunk trip
        counted. Returns `{"flops": total, "by_operator": {op: flops}}`.
        Unlike XLA's cost analysis, which counts a loop's body once, it
        counts every trip, so it equals `fused_pipeline_flops_estimate`."""
        cfg = self.cfg
        mesh_idx = self.mesh_db.label_to_index(detections.labels)
        args, inputs = self.fused_inputs(
            observation.images.to(self.device, torch.float32), observation.K.to(self.device, torch.float32),
            detections.bboxes.to(self.device, torch.float32), mesh_idx, cfg.n_refiner_iterations,
            cfg.n_pose_hypotheses)
        total, by_op = self._count_flops(self.pipeline, *args, *inputs)
        return {"flops": total, "by_operator": by_op}

    def fused_pipeline_flops_estimate(self, observation: ObservationTensor) -> dict[str, int]:
        """The model FLOPs of one fused pipeline call on one image at
        `max_detections` detections, the MFU numerator of a benchmark.

        Each distinct chunk sub-program (the hypotheses' initial poses of
        a sweep, `score_views` at the sweep's chunk, or the probe and
        children sweeps' when `SO3_prune_grid_size` is set, `refine_step`
        at the object chunk, the rescore) is counted once with
        `FlopCounterMode` over one real call on the estimator's device,
        then multiplied by its trip count; the shorter last chunk is its
        own sub-program. `FlopCounterMode` counts matmuls and convolutions
        (XLA's count also takes elementwise ops and normalizations), and
        K1, a ctypes launch, is opaque to it, as the Pallas call is to XLA.

        Returns {"flops", "flops_coarse", "flops_refine",
        "flops_rescore"}."""
        cfg = self.cfg
        D = cfg.max_detections
        dev = self.device
        images = observation.images[:1].to(dev, torch.float32)
        K = observation.K[:1].to(dev, torch.float32)
        H, W = images.shape[1:3]
        boxes = torch.tensor([[W / 4, H / 4, 3 * W / 4, 3 * H / 4]], device=dev).expand(D, 4)
        mesh_idx = torch.zeros(D, dtype=torch.long, device=dev)
        cache: dict[tuple, int] = {}

        def poses(n: int) -> Tensor:
            T = torch.eye(4, device=dev).repeat(n, 1, 1)
            T[:, 2, 3] = 0.5
            return T

        def score(model: PosePredictor, n: int) -> int:
            key = ("score", id(model), n)
            if key not in cache:
                cache[key] = self._count_flops(model.score_views, images, K.expand(n, 3, 3), poses(n),
                                               self.mesh_db_coarse.select(mesh_idx[:1].expand(n)))[0]
            return cache[key]

        def refine(n: int) -> int:
            return self._count_flops(self.refiner_model.refine_step, images, K.expand(n, 3, 3), poses(n),
                                     self.mesh_db.select(mesh_idx[:1].expand(n)))[0]

        def sweep(grid: Tensor) -> int:
            """Initial poses and scores of `D x M` hypotheses, `grid [M, 3,
            3]` or `[D, M, 3, 3]`."""
            n = D * grid.shape[-3]
            f = self._count_flops(self.init_hypotheses, K, boxes, mesh_idx, grid)[0]
            return f + sum(t * score(self.coarse_model_sweep, c) for c, t in self._chunks(n, min(cfg.bsz_images, n)))

        if cfg.SO3_prune_grid_size:
            n_children = min(cfg.SO3_prune_keep, self.so3_prune_grid.shape[0]) * self.prune_children.shape[1]
            f_coarse = sweep(self.so3_prune_grid) + sweep(self.so3_grid[:1].expand(D, n_children, 3, 3))
        else:
            f_coarse = sweep(self.so3_grid)
        N = D * cfg.n_pose_hypotheses
        chunks = self._chunks(N, min(cfg.bsz_objects, N))
        f_refine = cfg.n_refiner_iterations * sum(t * refine(c) for c, t in chunks)
        f_rescore = sum(t * score(self.coarse_model_rescore, c) for c, t in chunks)
        return {"flops": f_coarse + f_refine + f_rescore, "flops_coarse": f_coarse, "flops_refine": f_refine,
                "flops_rescore": f_rescore}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _run_external_init(
        self, observation: ObservationTensor, detections: TensorCollection, n_iter: int, do_depth: bool
    ) -> tuple[TensorCollection, dict[str, Any]]:
        """Refine and rescore the detections' `TCO_init` (ModelNet
        protocol); the depth stage where asked."""
        timing: dict[str, float] = {}
        t_start = self._clock()
        D = len(detections)
        mesh_idx = self.mesh_db.label_to_index(detections.labels)
        images = observation.images.to(self.device, torch.float32)
        K = observation.K.to(self.device, torch.float32)
        TCO_init = detections.TCO_init.to(self.device, torch.float32)
        chunk = min(self.cfg.bsz_objects, D)
        t0 = self._clock()
        TCO_refined, traj = self.refine(chunk, n_iter, images, K, TCO_init, mesh_idx)
        timing["refiner"] = self._clock() - t0
        t0 = self._clock()
        logits = self.rescore(chunk, images, K, TCO_refined, mesh_idx)
        timing["scoring"] = self._clock() - t0
        extra: dict[str, Any] = {"refiner": {"trajectory": traj}}
        if do_depth:
            refined, extra["depth_refiner"] = self.depth_refiner.refine_poses(
                TensorCollection(infos=detections.infos, poses=TCO_refined),
                depth=observation.depth, K=observation.K,
            )
            TCO_refined = refined.poses
        timing["total"] = self._clock() - t_start
        self.timing_ = extra["timing"] = timing
        return self._estimates(detections, TCO_refined, logits), extra

    @staticmethod
    def _estimates(detections: TensorCollection, poses: Tensor, logit: Tensor) -> TensorCollection:
        score = torch.sigmoid(logit)
        return TensorCollection(
            infos={**detections.infos, "pose_score": score.cpu().numpy(), "pose_logit": logit.cpu().numpy()},
            poses=poses, pose_score=score, pose_logit=logit,
        )

    @torch.inference_mode()
    def run_inference_pipeline(
        self,
        observation: ObservationTensor,
        detections: TensorCollection | None = None,
        run_detector: bool | None = None,
        n_refiner_iterations: int | None = None,
        n_pose_hypotheses: int | None = None,
        run_depth_refiner: bool | None = None,
        keep_all_coarse_outputs: bool = False,
    ) -> tuple[TensorCollection, dict[str, Any]]:
        """Full pipeline on ONE observation.

        Args:
          observation: batch size 1; with depth (4 channels) for the depth
            stage.
          detections: infos (`label`, `score`, ...) + `bboxes [D, 4]`, and
            `TCO_init [D, 4, 4]` for `coarse_estimation_type="external"`;
            None with `run_detector` takes the detector's.
          run_depth_refiner: None takes `cfg.run_depth_refiner`.
          keep_all_coarse_outputs: also return every coarse hypothesis's
            pose as `extra["coarse"]["all_TCO"]`.
        Returns:
          (the detections' infos with `pose_score` and `pose_logit` columns
          added, and the tensors `poses [D, 4, 4]`, `pose_score [D]`,
          `pose_logit [D]`; extra data with timing (per phase, or `total`
          alone in the fused mode) and intermediate results, among them the
          refiner's trajectory `[n_iter, D, K, 4, 4]`, the rescored logits
          `[D, K]` of all K hypotheses and, after a depth stage, the depth
          refiner's extra).
        """
        cfg = self.cfg
        n_iter = n_refiner_iterations or cfg.n_refiner_iterations
        top_k = n_pose_hypotheses or cfg.n_pose_hypotheses
        do_depth = cfg.run_depth_refiner if run_depth_refiner is None else run_depth_refiner
        if observation.batch_size != 1:
            raise ValueError("run_inference_pipeline takes one observation")
        if do_depth and (self.depth_refiner is None or observation.channels != 4):
            raise ValueError("the depth stage needs a depth_refiner and an observation with depth")
        if detections is None:
            if not run_detector or self.detector is None:
                raise ValueError("no detections: pass them, or run_detector=True with a detector")
            t0 = self._clock()
            detections = self.detector.get_detections(observation)
            t_detector = self._clock() - t0
        else:
            t_detector = None
        if len(detections) == 0:
            raise ValueError("no detections")
        if cfg.coarse_estimation_type == "external":
            if "TCO_init" not in detections.tensors:
                raise ValueError("external coarse estimation needs detections.TCO_init")
            return self._run_external_init(observation, detections, n_iter, do_depth)
        timing: dict[str, float] = {} if t_detector is None else {"detector": t_detector}
        t_start = self._clock()

        if len(detections) > cfg.max_detections:
            # Keep the highest-scoring rows, in their original order.
            scores = detections.infos.get("score")
            if scores is None:
                keep = np.arange(cfg.max_detections)
            else:
                order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
                keep = np.sort(order[: cfg.max_detections])
            detections = detections[keep]
        D = len(detections)
        mesh_idx = self.mesh_db.label_to_index(detections.labels)
        boxes = detections.bboxes.to(self.device, torch.float32)
        images = observation.images.to(self.device, torch.float32)
        K = observation.K.to(self.device, torch.float32)

        if cfg.fused_pipeline and not do_depth and self.device_mesh is None:
            # Static shapes: detections padded to max_detections.
            args, inputs = self.fused_inputs(images, K, boxes, mesh_idx, n_iter, top_k)
            out = self.fused(*args, *inputs)
            out = {k: (v[:, :D] if k == "traj" else v[:D]).clone() for k, v in out.items()}
        else:
            out = self.pipeline(min(cfg.bsz_images, D * self.so3_grid.shape[0]), cfg.bsz_objects, n_iter,
                                top_k, images, K, boxes, mesh_idx, timing=timing)
        TCO_best = out["TCO_best"]

        depth_extra = None
        if do_depth:
            t0 = self._clock()
            refined, depth_extra = self.depth_refiner.refine_poses(
                TensorCollection(infos=detections.infos, poses=TCO_best),
                depth=observation.depth, K=observation.K,
            )
            TCO_best = refined.poses
            timing["depth_refiner"] = self._clock() - t0
        timing["total"] = self._clock() - t_start
        self.timing_ = timing

        extra = {
            "timing": timing,
            "coarse": {"logits": out["logits"], "TCO_init": out["TCO_init"], "top_ids": out["top_ids"]},
            "refiner": {
                "trajectory": out["traj"],
                "TCO_refined": out["TCO_refined"],
                "pose_logits": out["pose_logits_dk"],
            },
        }
        if keep_all_coarse_outputs:
            extra["coarse"]["all_TCO"] = out["TCO_init"]
        if depth_extra is not None:
            extra["depth_refiner"] = depth_extra
        return self._estimates(detections, TCO_best, out["best_logit"]), extra
