"""Synthetic datasets rendered on the device: webdataset shards or a BOP tree.

Counterpart of `megapose6d_tpu/scripts/generate_synthetic_dataset.py`.
Multi-object scenes are rendered through the tiled rasterizer (the CUDA
visibility kernel on the card, twice per scene with shadows: the main view
and the light's view), z-composited and shaded in a deferred pass over a
procedural background. A scene's random draws are the JAX package's, bit
for bit (`utils/threefry.py`, drawn on the host), so a key gives the same
scene in both packages; the shading is float32 torch, so an 8-bit level can
differ where the two round a value on either side of an integer.

    python -m megapose6d_tpu_torch.scripts.generate_synthetic_dataset \\
        out_dir=build/synth_wds n_frames=1000 [resolution=480,640] [n_obj_per_scene=3] \\
        [format=wds|bop] [object_dataset=<name>] [rank=0 world_size=1] [device=cpu]
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import numpy as np
import torch

from ..data.bop_writer import write_bop_models, write_scene_ds_as_bop
from ..data.scene_dataset import ObservationInfos, SceneObservation
from ..data.types import CameraData, ObjectData
from ..data.web_scene_dataset import write_scene_ds_as_wds
from ..evaluation.bop import label_to_obj_id
from ..meshes.io import make_cube, make_cylinder, make_uv_sphere
from ..meshes.mesh_db import BatchedMeshes, MeshDataBase, RigidObject, RigidObjectDataset
from ..ops import rasterizer_tiled
from ..ops._precision import pin_f32
from ..ops.camera import look_at_R
from ..ops.se3 import invert_se3, make_se3, rotmat_from_quat
from ..ops.so3_grid import super_fibonacci_quats
from ..training.train import random_background
from ..utils import threefry

logger = logging.getLogger(__name__)

Tensor = torch.Tensor
Z_BG = 1.45  # depth of the background plane, behind the farthest object
N_QUATS = 4096  # the pool of object rotations


def _intrinsics(f: float, resolution: tuple[int, int]) -> np.ndarray:
    H, W = resolution
    return np.asarray([[f, 0.0, W / 2 - 0.5], [0.0, f, H / 2 - 0.5], [0.0, 0.0, 1.0]], np.float32)


def _env_sample(c0: Tensor, c1: Tensor, n: Tensor) -> Tensor:
    """Degree-1 environment light: `c0 + n @ c1`, clipped to [0, 2]; `n
    [N, H, W, 3]` eye-space normals, `c0 [N, 3]`, `c1 [N, 3, 3]`."""
    return (c0[:, None, None] + torch.einsum("nhwj,njc->nhwc", n, c1)).clamp(0.0, 2.0)


class SceneRenderer:
    """Scenes of `n_obj` objects of `mesh_db` at `resolution` with focal
    `f`. `draw(key)` makes one scene's random draws on the host (as the JAX
    renderer's `fn(key, key_light)` draws them); `render(draws)` renders a
    batch of scenes on the mesh database's device; a call does both for
    keys `[N, 2]` (or one key).

    Domains: `background` (a procedural colour field, else black),
    `shadows` (a shadow map from a second pass at the light, depth-tested
    per pixel), `ibl` (ambient light from a degree-1 environment tinted by
    the background) and `unlit` (flat albedo, no light: the training
    batches' statistics; turns shadows and ibl off).

    `render` returns, with a leading scene axis N: `rgb [N, H, W, 3]` in [0,
    1], `depth [N, H, W]` (0 off the objects), `seg [N, H, W]` int32 (object
    n + 1, 0 background), `TCO [N, n_obj, 4, 4]`, `mesh_idx [N, n_obj]`,
    `visib [N, n_obj]` (visible over unoccluded pixels) and `K [3, 3]`."""

    def __init__(self, mesh_db: BatchedMeshes, n_obj: int, resolution: tuple[int, int], f: float,
                 background: bool = True, shadows: bool = True, ibl: bool = True, unlit: bool = False):
        pin_f32()
        self.mesh_db, self.n_obj = mesh_db, n_obj
        self.resolution = H, W = tuple(resolution)
        self.background = background
        self.shadows, self.ibl, self.unlit = (shadows and not unlit), (ibl and not unlit), unlit
        dev = mesh_db.device
        self.K = torch.as_tensor(_intrinsics(f, self.resolution), device=dev)
        self.K_light = torch.as_tensor(_intrinsics(1.1 * max(H, W), self.resolution), device=dev)
        self.quat_pool = torch.as_tensor(super_fibonacci_quats(N_QUATS), dtype=torch.float32, device=dev)
        vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        # Pixel-centre rays: X_c = depth * (rays, 1).
        self.rays = torch.stack([(uu - self.K[0, 2]) / self.K[0, 0], (vv - self.K[1, 2]) / self.K[1, 1]], -1)

    def draw(self, key: np.ndarray, key_light: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """One scene's draws, in the JAX renderer's order: `split(key, 9)`,
        the lighting keys from `split(key_light, 4)` when given."""
        k1, k2, k3, k4, k5, k6, k7, k8, k9 = threefry.split(key, 9)
        if key_light is not None:
            k5, k6, k8, k9 = threefry.split(key_light, 4)
        n, L = self.n_obj, len(self.mesh_db.labels)
        b1, b2, b3 = threefry.split(k7, 3)
        return dict(
            mesh_idx=threefry.randint(k1, (n,), 0, L).astype(np.int64),
            quat_idx=threefry.randint(k2, (n,), 0, N_QUATS).astype(np.int64),
            z=threefry.uniform(k3, (n, 1), 0.5, 1.2),
            xy=threefry.uniform(k4, (n, 2), -0.12, 0.12),
            amb=threefry.uniform(k5, (), 0.5, 0.9),
            pnt=threefry.uniform(k6, (), 0.25, 0.65),
            bg_coarse=threefry.uniform(b1, (6, 8, 3), 0.0, 1.0),
            bg_fine=threefry.uniform(b2, (24, 32, 3), -0.15, 0.15),
            bg_gain=threefry.uniform(b3, (), 0.4, 1.0),
            lx=threefry.uniform(k8, (), -1.0, 1.0),
            lz=threefry.uniform(k9, (), -0.4, 0.9),
            ibl=threefry.uniform(threefry.fold_in(k7, 1), (3, 3), -0.3, 0.3),
        )

    def draws(self, keys: np.ndarray, key_lights: np.ndarray | None = None) -> dict[str, Tensor]:
        """The draws of the scenes of `keys [N, 2]`, stacked, on the device."""
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        lights = [None] * len(keys) if key_lights is None else np.asarray(key_lights, np.uint32).reshape(-1, 2)
        per = [self.draw(k, kl) for k, kl in zip(keys, lights)]
        return {k: torch.as_tensor(np.stack([d[k] for d in per]), device=self.mesh_db.device) for k in per[0]}

    def __call__(self, keys: np.ndarray, key_lights: np.ndarray | None = None) -> dict[str, Tensor]:
        return self.render(self.draws(keys, key_lights))

    def render(self, d: dict[str, Tensor]) -> dict[str, Tensor]:
        N, n = d["mesh_idx"].shape
        H, W = self.resolution
        # A pool rotation at (xy z, z).
        TCO = make_se3(rotmat_from_quat(self.quat_pool[d["quat_idx"]]), torch.cat([d["xy"] * d["z"], d["z"]], -1))
        meshes = self.mesh_db.select(d["mesh_idx"].reshape(-1))
        mesh_args = (meshes.vertices, meshes.normals, meshes.colors, meshes.faces, meshes.face_valid)
        # Main pass: unlit albedo, normals and depth; the light comes in the
        # deferred composite below.
        out = rasterizer_tiled.render_meshes_tiled(
            *mesh_args, TCO.reshape(-1, 4, 4), self.K.expand(N * n, 3, 3), (H, W),
            light_ambient=1.0, light_point=0.0, **meshes.texture_kw)
        mask = out.mask.reshape(N, n, H, W)
        depth_l = torch.where(mask, out.depth.reshape(N, n, H, W), torch.inf)
        winner = depth_l.argmin(1)  # [N, H, W], the first layer on ties
        any_hit = mask.any(1)

        def take(a: Tensor) -> Tensor:  # [N * n, H, W, C] -> the winning layer [N, H, W, C]
            a = a.reshape(N, n, H, W, -1)
            return a.gather(1, winner[:, None, ..., None].expand(N, 1, H, W, a.shape[-1]))[:, 0]

        albedo = take(out.rgb)
        n_eye = take(out.normals) * 2.0 - 1.0
        depth = torch.where(any_hit, take(out.depth[..., None])[..., 0], 0.0)
        seg = torch.where(any_hit, winner + 1, 0).to(torch.int32)
        if self.background:
            bg = random_background(d["bg_coarse"], d["bg_fine"], d["bg_gain"], (H, W))
        else:
            bg = torch.zeros_like(albedo)

        # A point light above the scene (camera frame: -y is up).
        light_pos = torch.stack([d["lx"], torch.full_like(d["lx"], -1.2), 0.85 + d["lz"]], -1)  # [N, 3]
        target = torch.zeros_like(light_pos)
        target[:, 2] = 0.85
        if self.ibl:
            c0 = bg.mean((1, 2)) * 0.7 + 0.3 if self.background else torch.ones_like(light_pos)
            env = lambda nrm: 0.35 + 0.65 * _env_sample(c0, d["ibl"] * c0[:, None, :], nrm)
        else:
            env = torch.ones_like
        # Shading points: the object surface where hit, else the background
        # plane (normal -z, facing the camera).
        pix_depth = torch.where(any_hit, depth, Z_BG)
        X_c = torch.cat([self.rays * pix_depth[..., None], pix_depth[..., None]], -1)  # [N, H, W, 3]
        facing = torch.zeros_like(X_c)
        facing[..., 2] = -1.0
        n_pix = torch.where(any_hit[..., None], n_eye, facing)
        l_dir = light_pos[:, None, None] - X_c
        l_dir = l_dir / torch.linalg.norm(l_dir, dim=-1, keepdim=True).clamp_min(1e-6)
        n_dot_l = (n_pix * l_dir).sum(-1).clamp(0.0, 1.0)
        lit = self._shadow(d, meshes, mesh_args, TCO, light_pos, target, X_c, n_dot_l) if self.shadows else 1.0

        if self.unlit:
            shade = torch.ones_like(n_dot_l)[..., None]
        else:
            shade = d["amb"][:, None, None, None] * env(n_pix) + d["pnt"][:, None, None, None] * (n_dot_l * lit)[..., None]
        fg_rgb = (albedo * shade).clamp(0.0, 1.0)
        bg_rgb = (bg * shade).clamp(0.0, 1.0)
        rgb = torch.where(any_hit[..., None], fg_rgb, bg_rgb)
        layer_px = mask.sum((2, 3))
        objs = torch.arange(n, device=winner.device)[None, :, None, None]
        vis_px = ((winner[:, None] == objs) & any_hit[:, None]).sum((2, 3))
        visib = vis_px / layer_px.clamp_min(1)
        return dict(rgb=rgb, depth=depth, seg=seg, TCO=TCO, mesh_idx=d["mesh_idx"], K=self.K, visib=visib)

    def _shadow(self, d, meshes, mesh_args, TCO, light_pos, target, X_c, n_dot_l) -> Tensor:
        """Lit share `[N, H, W]` of each shading point: a shadow map (the
        light's view, min-composited over the objects; a second pass through
        the rasterizer), each point reprojected into it and depth-tested,
        averaged with the test one pixel below."""
        N, n = d["mesh_idx"].shape
        H, W = self.resolution
        up = torch.zeros_like(light_pos)
        up[:, 1] = -1.0
        T_LC = invert_se3(make_se3(look_at_R(light_pos, target, up), light_pos))  # camera -> light
        TLO = T_LC[:, None] @ TCO
        out_l = rasterizer_tiled.render_meshes_tiled(
            *mesh_args, TLO.reshape(-1, 4, 4), self.K_light.expand(N * n, 3, 3), (H, W),
            light_ambient=1.0, light_point=0.0)
        shadow_depth = torch.where(out_l.mask, out_l.depth, torch.inf).reshape(N, n, H, W).amin(1)
        X_l = torch.einsum("nij,nhwj->nhwi", T_LC[:, :3, :3], X_c) + T_LC[:, None, None, :3, 3]
        zl = X_l[..., 2].clamp_min(1e-4)
        Kl = self.K_light
        ul = Kl[0, 0] * X_l[..., 0] / zl + Kl[0, 2]
        vl = Kl[1, 1] * X_l[..., 1] / zl + Kl[1, 2]
        iu = torch.round(ul).to(torch.int32).clamp(0, W - 1)  # half to even, as jnp.round
        iv = torch.round(vl).to(torch.int32).clamp(0, H - 1)
        flat = shadow_depth.reshape(N, H * W)
        lookup = lambda v: flat.gather(1, (v * W + iu).reshape(N, -1).long()).reshape(N, H, W)
        d_map = lookup(iv)
        in_map = (ul >= 0) & (ul <= W - 1) & (vl >= 0) & (vl <= H - 1)
        bias = 5e-3 + 3e-2 * (1.0 - n_dot_l)
        tested = in_map & torch.isfinite(d_map)
        lit = torch.where(tested, zl <= d_map + bias, True).float()
        below = (zl <= lookup((iv + 1).clamp(0, H - 1)) + bias).float()
        return 0.5 * lit + 0.5 * torch.where(tested, below, 1.0)


def make_scene_renderer(mesh_db: BatchedMeshes, n_obj: int, resolution: tuple[int, int], f: float,
                        background: bool = True, shadows: bool = True, ibl: bool = True,
                        unlit: bool = False) -> SceneRenderer:
    """The scene renderer of the JAX package's name: a `SceneRenderer`,
    called on keys `[N, 2]` (or one key)."""
    return SceneRenderer(mesh_db, n_obj, resolution, f, background=background, shadows=shadows, ibl=ibl,
                         unlit=unlit)


def to_observation(out: dict[str, Tensor], labels, i: int, infos: ObservationInfos,
                   with_boxes: bool) -> SceneObservation:
    """Scene `i` of a render as a `SceneObservation` (rgb truncated to 8
    bits as the JAX generator does): one `ObjectData` per object with at
    least 16 visible pixels, with its visible box when `with_boxes`."""
    rgb8 = (out["rgb"][i] * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()
    seg = out["seg"][i].cpu().numpy().astype(np.uint32)
    TCO = out["TCO"][i].cpu().numpy().astype(np.float64)
    mesh_idx, visib = out["mesh_idx"][i].tolist(), out["visib"][i].tolist()
    object_datas = []
    for n in range(len(mesh_idx)):
        ys, xs = np.nonzero(seg == n + 1)
        if len(ys) < 16:
            continue
        box = np.asarray([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float64) if with_boxes else None
        object_datas.append(ObjectData(label=labels[mesh_idx[n]], TWO=TCO[n], unique_id=n + 1, bbox_modal=box,
                                       visib_fract=float(visib[n])))
    H, W = seg.shape
    return SceneObservation(rgb=rgb8, depth=out["depth"][i].cpu().numpy().astype(np.float32), segmentation=seg,
                            infos=infos, object_datas=object_datas,
                            camera_data=CameraData(K=out["K"].cpu().numpy().astype(np.float64), resolution=(H, W)))


def generate(mesh_db: BatchedMeshes, out_dir: str | Path, n_frames: int, resolution=(480, 640),
             n_obj_per_scene: int = 3, f: float = 600.0, frames_per_shard: int = 1000, seed: int = 0,
             rank: int = 0, world_size: int = 1) -> list[Path]:
    """Render `n_frames` frames into webdataset shards. Shard `s` holds
    frames `[s * fps, (s + 1) * fps)`, frame `i` keyed `fold_in(seed, i)`;
    rank `r` renders shards r, r + world_size, ... and skips shards whose
    tar exists (a resumed run)."""
    out_dir = Path(out_dir)
    render = SceneRenderer(mesh_db, n_obj_per_scene, resolution, f)
    fps = frames_per_shard
    base_key = threefry.PRNGKey(seed)

    def observations(frames):
        for i in frames:
            out = render(threefry.fold_in(base_key, i))
            yield to_observation(out, mesh_db.labels, 0, ObservationInfos(scene_id=str(i // 100), view_id=i), True)
            if (i + 1) % 500 == 0:
                logger.info("rendered %d/%d frames", i + 1, n_frames)

    shards: list[Path] = []
    for s in range(rank, (n_frames + fps - 1) // fps, world_size):
        path = out_dir / f"shard-{s:06d}.tar"
        if path.exists():
            logger.info("shard %s exists, skipping", path.name)
            shards.append(path)
            continue
        frames = range(s * fps, min((s + 1) * fps, n_frames))
        shards += write_scene_ds_as_wds(observations(frames), out_dir, frames_per_shard=len(frames),
                                        shard_offset=s, frame_id_offset=frames.start)
    logger.info("rank %d/%d: %d shards in %s", rank, world_size, len(shards), out_dir)
    return shards


def generate_bop(mesh_db: BatchedMeshes, objects: RigidObjectDataset, ds_dir: str | Path, n_frames: int,
                 resolution=(480, 640), n_obj_per_scene: int = 3, f: float = 600.0, frames_per_scene: int = 100,
                 seed: int = 0, split: str = "test", write_models: bool = True, background: bool = True,
                 shadows: bool = True, ibl: bool = True, unlit: bool = False) -> Path:
    """The BOP-layout variant of `generate` (`data/bop_writer.py`), for the
    BOP reader, the runners and the meters. Frame `i` is keyed by the i-th
    `key, sub = split(key)` from `PRNGKey(seed)`; `background`, `shadows`,
    `ibl` and `unlit` are `SceneRenderer`'s."""
    ds_dir = Path(ds_dir)
    render = make_scene_renderer(mesh_db, n_obj_per_scene, resolution, f, background=background,
                                 shadows=shadows, ibl=ibl, unlit=unlit)
    if write_models:
        write_bop_models(((label_to_obj_id(o.label), o.load()) for o in objects.objects), ds_dir / "models")

    def observations():
        key = threefry.PRNGKey(seed)
        for i in range(n_frames):
            key, sub = threefry.split(key)
            infos = ObservationInfos(scene_id=str(i // frames_per_scene), view_id=i)
            yield to_observation(render(sub), mesh_db.labels, 0, infos, False)
            if (i + 1) % 500 == 0:
                logger.info("rendered %d/%d frames", i + 1, n_frames)

    out = write_scene_ds_as_bop(observations(), ds_dir, split=split)
    logger.info("wrote BOP split %s", out)
    return out


def _default_objects() -> RigidObjectDataset:
    """Procedural objects with BOP labels: three textured (random block
    textures) and a plain cylinder."""
    return RigidObjectDataset([
        RigidObject(label="obj_000001", mesh=make_cube(0.04, textured=True, seed=11)),
        RigidObject(label="obj_000002", mesh=make_uv_sphere(0.04, 24, 32, textured=True, seed=12)),
        RigidObject(label="obj_000003", mesh=make_cylinder(0.025, 0.09, n_seg=32)),
        RigidObject(label="obj_000004", mesh=make_uv_sphere(0.03, 20, 28, textured=True, seed=13)),
    ])


DEFAULTS = dict(out_dir="synth_wds", n_frames="1000", object_dataset="", resolution="480,640",
                n_obj_per_scene="3", frames_per_shard="1000", seed="0", format="wds", split="test", rank="0",
                world_size="1", data_dir="", device="cuda")


def main(argv=None):
    args = dict(DEFAULTS)
    for a in sys.argv[1:] if argv is None else argv:
        k, _, v = a.partition("=")
        if k not in args:
            raise ValueError(f"unknown arg {k}")
        args[k] = v
    if args["object_dataset"]:
        from ..data.datasets_cfg import make_object_dataset

        objects = make_object_dataset(args["object_dataset"], data_dir=args["data_dir"] or None)
        write_models = False  # a BOP source dataset ships its models/
    else:
        objects, write_models = _default_objects(), True
    mesh_db = MeshDataBase.from_object_ds(objects).batched(device=args["device"])
    res = tuple(int(x) for x in args["resolution"].split(","))
    common = dict(resolution=res, n_obj_per_scene=int(args["n_obj_per_scene"]), seed=int(args["seed"]))
    if args["format"] == "bop":
        return generate_bop(mesh_db, objects, args["out_dir"], int(args["n_frames"]), split=args["split"],
                            write_models=write_models, **common)
    if args["format"] != "wds":
        raise ValueError(f"format must be wds or bop, not {args['format']}")
    return generate(mesh_db, args["out_dir"], int(args["n_frames"]), frames_per_shard=int(args["frames_per_shard"]),
                    rank=int(args["rank"]), world_size=int(args["world_size"]), **common)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
