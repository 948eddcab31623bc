"""Tutorial CLI: run the pose pipeline on an example directory.

Counterpart of `megapose6d_tpu/scripts/run_inference_on_example.py`, with
the same example-directory contract:

    <example_dir>/
      image_rgb.png            (+ image_depth.png, metres * 1000, uint16)
      camera_data.json         ({"K": ..., "resolution": [h, w]})
      inputs/object_data.json  ([{"label", "bbox_modal"}, ...])
      meshes/<label>/<mesh file> or meshes/<label>.{ply,obj}  (millimetres)
      outputs/object_data.json (written: [{"label", "TWO"}, ...])

The models come from training run directories (`--coarse-run`,
`--refiner-run`): their configurations and the trained weights of their
latest checkpoints (the JAX package's orbax ones or the port's).
`--coarse-weights` / `--refiner-weights` override those with a weight
file or checkpoint; without a run or weights a model is drawn from a
seed (a smoke test of the pipeline, no meaningful poses).
`--depth` adds `image_depth.png` to the observation as its depth channel.

    python -m megapose6d_tpu_torch.scripts.run_inference_on_example <dir> \\
        --run-inference [--depth] [--coarse-run runs/coarse_dr --refiner-run runs/refiner_dr] [--device cpu] \\
        [--vis-detections] [--vis-outputs]

`--vis-detections` writes `visualizations/detections.png` (the input boxes
over the image); `--vis-outputs`, with `--run-inference`, writes
`outputs/scene.html` (the HTML scene viewer with the camera and the
estimated poses) and `visualizations/pose_overlay.png` and
`contour_overlay.png` (the estimates rendered over the image).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from ..data.types import (
    CameraData,
    ObjectData,
    ObservationTensor,
    object_data_from_json_path,
    object_data_to_json_path,
)
from ..inference.load_model import load_or_init_models
from ..inference.pose_estimator import PoseEstimator
from ..inference.types import InferenceConfig, make_detections
from ..meshes.mesh_db import RigidObject, RigidObjectDataset
from ..utils.png import read_png

logger = logging.getLogger(__name__)

MESH_SUFFIXES = (".ply", ".obj")


def make_object_dataset(example_dir: Path) -> RigidObjectDataset:
    """The meshes under `<dir>/meshes`, in millimetres."""
    objects = []
    for entry in sorted((example_dir / "meshes").iterdir()):
        if entry.is_dir():
            mesh = next((f for f in sorted(entry.iterdir()) if f.suffix.lower() in MESH_SUFFIXES), None)
            if mesh is not None:
                objects.append(RigidObject(label=entry.name, mesh_path=mesh, mesh_units="mm"))
        elif entry.suffix.lower() in MESH_SUFFIXES:
            objects.append(RigidObject(label=entry.stem, mesh_path=entry, mesh_units="mm"))
    if not objects:
        raise FileNotFoundError(f"no meshes under {example_dir / 'meshes'}")
    return RigidObjectDataset(objects)


def load_observation(example_dir: Path, load_depth: bool = False, device="cuda") -> ObservationTensor:
    """The rgb image, its camera and, with `load_depth` and where the file
    exists, `image_depth.png` in metres."""
    camera_data = CameraData.from_json((example_dir / "camera_data.json").read_text())
    rgb = read_png(example_dir / "image_rgb.png")[..., :3]
    depth = None
    if load_depth and (example_dir / "image_depth.png").exists():
        depth = read_png(example_dir / "image_depth.png").astype(np.float32) / 1000.0
    return ObservationTensor.from_numpy(rgb, depth, camera_data.K, device=device)


def load_detections(example_dir: Path, device="cuda"):
    objs = object_data_from_json_path(example_dir / "inputs" / "object_data.json")
    return make_detections([o.label for o in objs], np.stack([o.bbox_modal for o in objs]), device=device)


def vis_detections(args) -> Path:
    """`--vis-detections`: the input boxes over the rgb image."""
    from ..visualization.plotter import plot_detections

    example_dir = Path(args.example_dir)
    observation = load_observation(example_dir, device=args.device)
    out = example_dir / "visualizations" / "detections.png"
    out.parent.mkdir(exist_ok=True)
    plot_detections(observation.images[0, ..., :3], load_detections(example_dir, device=args.device), out_path=out)
    logger.info("wrote %s", out)
    return out


def vis_outputs(example_dir: Path, observation: ObservationTensor, data, mesh_db) -> list[Path]:
    """`--vis-outputs`: the scene viewer's HTML (camera and estimates) and
    the pose and contour overlays."""
    from ..visualization.plotter import plot_pose_overlay
    from ..visualization.scene_viewer import SceneViewer

    def mesh_for_label(label):
        i = int(mesh_db.label_to_index([label])[0])
        valid = mesh_db.face_valid[i].cpu().numpy()
        return (mesh_db.vertices[i].cpu().numpy(), mesh_db.faces[i].cpu().numpy()[valid],
                mesh_db.colors[i].cpu().numpy())

    viewer = SceneViewer(title=f"{example_dir.name} estimates")
    K = observation.K[0].cpu().numpy()
    h, w = observation.images.shape[1:3]
    viewer.add_camera("camera", K, (h, w), TWC=np.eye(4))
    viewer.add_pose_estimates(data, mesh_for_label)
    html = viewer.write_html(example_dir / "outputs" / "scene.html")
    vis = example_dir / "visualizations"
    vis.mkdir(exist_ok=True)
    plot_pose_overlay(observation.images[0, ..., :3], mesh_db, list(data.labels), data.poses, K,
                      out_path=vis / "pose_overlay.png", contour_out_path=vis / "contour_overlay.png")
    logger.info("wrote %s, %s and %s", html, vis / "pose_overlay.png", vis / "contour_overlay.png")
    return [html, vis / "pose_overlay.png", vis / "contour_overlay.png"]


def run_inference(args) -> Path:
    example_dir = Path(args.example_dir)
    observation = load_observation(example_dir, load_depth=args.depth, device=args.device)
    detections = load_detections(example_dir, device=args.device)
    coarse, refiner, mesh_db = load_or_init_models(
        make_object_dataset(example_dir), args.coarse_run, args.refiner_run,
        coarse_weights=args.coarse_weights, refiner_weights=args.refiner_weights, device=args.device,
    )
    cfg = InferenceConfig(
        SO3_grid_size=args.so3_grid_size,
        n_refiner_iterations=args.n_refiner_iterations,
        n_pose_hypotheses=args.n_pose_hypotheses,
        max_detections=max(1, len(detections)),
        bsz_images=args.bsz_images,
    )
    estimator = PoseEstimator(coarse, refiner, mesh_db, cfg, device=args.device)
    logger.info("running the inference pipeline")
    data, _ = estimator.run_inference_pipeline(observation, detections)
    logger.info("timing: %s", estimator.timing_)
    poses = data.poses.cpu().numpy()
    out = [ObjectData(label=label, TWO=poses[i]) for i, label in enumerate(data.labels)]
    out_path = example_dir / "outputs" / "object_data.json"
    out_path.parent.mkdir(exist_ok=True)
    object_data_to_json_path(out, out_path)
    logger.info("wrote %s", out_path)
    if args.vis_outputs:
        vis_outputs(example_dir, observation, data, mesh_db)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("example_dir")
    parser.add_argument("--run-inference", action="store_true")
    parser.add_argument("--depth", action="store_true")
    parser.add_argument("--coarse-run", default=None)
    parser.add_argument("--refiner-run", default=None)
    parser.add_argument("--coarse-weights", default=None)
    parser.add_argument("--refiner-weights", default=None)
    parser.add_argument("--so3-grid-size", type=int, default=576)
    parser.add_argument("--n-refiner-iterations", type=int, default=5)
    parser.add_argument("--n-pose-hypotheses", type=int, default=5)
    parser.add_argument("--bsz-images", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--vis-outputs", action="store_true",
                        help="write outputs/scene.html and visualizations/pose_overlay.png, contour_overlay.png")
    parser.add_argument("--vis-detections", action="store_true",
                        help="write visualizations/detections.png (the input boxes over the image)")
    args = parser.parse_args(argv)
    if args.vis_detections:
        vis_detections(args)
    if args.run_inference:
        return run_inference(args)
    if not args.vis_detections:
        parser.print_help()
    return None


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
