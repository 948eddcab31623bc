"""Training configuration and the `key=value` dotlist of the CLI.

Counterpart of `megapose6d_tpu/training/config.py` (pure Python; the port
keeps its own copy). `load_config` reads the committed `runs/*/config.json`
files unchanged. `tile_hyp_pack` is kept so those files round-trip; it
packs hypotheses per Pallas program on the TPU and has no counterpart in
the port's renderer, so `model_config_kwargs` leaves it out.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class TrainingConfig:
    # --- run ---------------------------------------------------------
    run_id: str = "run"
    run_dir: str = "runs"
    seed: int = 0
    # Resume a previous run (full state: params+optimizer+step; continue at
    # saved epoch + 1) or initialize weights from one (pretrain). Both name
    # a run_id under run_dir (run_megapose_training.py:315-320,
    # train_megapose.py:219-241).
    resume_run_id: str = ""
    pretrain_run_id: str = ""

    # --- data --------------------------------------------------------
    train_datasets: tuple[str, ...] = ()
    input_resize: tuple[int, int] = (540, 720)
    input_depth: bool = False
    n_dataloader_workers: int = 4
    min_area: float = 1000.0

    # --- model -------------------------------------------------------
    backbone_str: str = "resnet34"
    render_size: tuple[int, int] = (240, 320)
    n_rendered_views: int = 1
    multiview_type: str = "front_3views"
    views_inplane_rotations: bool = False
    remove_TCO_rendering: bool = False
    render_normals: bool = True
    render_depth: bool = False
    predict_pose_update: bool = True
    predict_rendered_views_logits: bool = False
    depth_normalization_type: str = "none"
    compute_dtype: str = "float32"

    # --- hypotheses (training_config.py:93-103) ------------------------
    hypotheses_init_method: str = "refiner_gt+noise"
    n_hypotheses: int = 1
    init_euler_deg_std: tuple[float, float, float] = (15.0, 15.0, 15.0)
    init_trans_std: tuple[float, float, float] = (0.01, 0.01, 0.05)
    random_ambient_light: bool = False
    # coarse_classif_grid: a hypothesis is positive iff within this angle
    # of the GT rotation orbit (matched to the 576-cell grid spacing).
    coarse_pos_angle_deg: float = 30.0
    # Fraction of candidates drawn as GT-composed rotations with angle
    # ~U[0, coarse_hard_neg_max_deg] instead of Haar-uniform. Haar
    # negatives are almost always >60 deg from GT, so without these the
    # positive/negative boundary (the thing 576-grid ranking needs) gets
    # ~no supervision and training accuracy saturates within ~2k steps.
    coarse_hard_neg_frac: float = 0.5
    coarse_hard_neg_max_deg: float = 90.0
    # The JAX package's hypotheses per Pallas program; unused by the port.
    tile_hyp_pack: int = 4

    # --- loss ---------------------------------------------------------
    n_points_loss: int = 1000
    loss_alpha_pose: float = 1.0
    loss_alpha_renderings_confidence: float = 1.0
    renderings_logits_temperature: float = 1.0

    # --- optimizer (training_config.py:104-119) ------------------------
    optimizer: str = "adam"
    lr: float = 3e-4
    weight_decay: float = 0.0
    n_epochs_warmup: int = 50
    lr_epoch_decay: int = 500
    clip_grad_norm: float = 0.5

    # --- schedule -------------------------------------------------------
    batch_size: int = 16
    epoch_size: int = 115200
    n_epochs: int = 700
    n_iterations: int = 3  # refiner train iterations
    add_iteration_epoch_interval: int = 0  # ramp like train_megapose.py:272
    val_epoch_interval: int = 10
    save_epoch_interval: int = 100

    # --- mesh db -------------------------------------------------------
    n_max_objects: int | None = None
    max_faces: int = 4096
    n_sym: int = 32
    n_points_mesh: int = 2000

    def model_config_kwargs(self) -> dict[str, Any]:
        """Fields forwarded to the port's `PosePredictorConfig`."""
        mv = self.multiview_type
        if not mv.startswith("TCO+") and not mv.startswith("sphere"):
            mv = f"TCO+{mv}"
        return dict(
            backbone=self.backbone_str,
            render_size=tuple(self.render_size),
            n_rendered_views=self.n_rendered_views,
            multiview_type=mv,
            views_inplane_rotations=self.views_inplane_rotations,
            remove_TCO_rendering=self.remove_TCO_rendering,
            render_normals=self.render_normals,
            render_depth=self.render_depth,
            predict_pose_update=self.predict_pose_update,
            predict_rendered_views_logits=self.predict_rendered_views_logits,
            input_depth=self.input_depth,
            depth_normalization_type=self.depth_normalization_type,
            compute_dtype=self.compute_dtype,
        )


def _coerce(value: str, current: Any, hint: str = "") -> Any:
    """String -> field value, typed by the current value or (when the
    default is None) the dataclass annotation string `hint`. Shared by
    the training and eval CLIs (the one dotlist syntax)."""
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        parts = [p for p in value.strip("[]() ").split(",") if p]
        elem = current[0] if current else value
        return tuple(type(elem)(p.strip()) for p in parts)
    if isinstance(current, list) or (current is None and "list" in hint):
        try:
            out = json.loads(value)
            return out if isinstance(out, list) else [out]
        except json.JSONDecodeError:
            return [p.strip() for p in value.split(",") if p.strip()]
    if current is None and "int" in hint:
        return int(value)
    if current is None and "float" in hint:
        return float(value)
    if current is None and not hint:
        try:
            return json.loads(value)
        except json.JSONDecodeError:
            return value
    return value


def apply_overrides(cfg: TrainingConfig, argv: list[str]) -> TrainingConfig:
    """`key=value` dotlist overrides (OmegaConf.from_cli analog)."""
    updates = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        if not hasattr(cfg, key):
            raise ValueError(f"unknown config key {key!r}")
        updates[key] = _coerce(value, getattr(cfg, key))
    return dataclasses.replace(cfg, **updates)


def save_config(cfg: TrainingConfig, path: str | Path) -> None:
    """Persist alongside checkpoints (training/utils.py:156-157)."""
    d = dataclasses.asdict(cfg)
    Path(path).write_text(json.dumps(d, indent=2, default=str))


def load_config(path: str | Path) -> TrainingConfig:
    d = json.loads(Path(path).read_text())
    field_types = {f.name: f for f in dataclasses.fields(TrainingConfig)}
    kw = {}
    for k, v in d.items():
        if k in field_types:
            kw[k] = tuple(v) if isinstance(v, list) else v
    return TrainingConfig(**kw)


# ------------------------------------------------------------------
# Named experiment presets (run_megapose_training.py:120-272)
# ------------------------------------------------------------------

def make_refiner_cfg(cfg: TrainingConfig) -> TrainingConfig:
    return dataclasses.replace(
        cfg,
        n_rendered_views=4,
        multiview_type="front_3views",
        render_normals=True,
        predict_pose_update=True,
        predict_rendered_views_logits=False,
        hypotheses_init_method="refiner_gt+noise",
        n_hypotheses=1,
        n_iterations=3,
    )


def make_coarse_cfg(cfg: TrainingConfig) -> TrainingConfig:
    return dataclasses.replace(
        cfg,
        n_rendered_views=1,
        render_normals=True,
        predict_pose_update=False,
        predict_rendered_views_logits=True,
        # Default switched from the reference's multiview recipe to the
        # inference-aligned grid recipe (see forward_loss.py
        # coarse_classif_grid): box-fitted uniform-rotation negatives.
        # "coarse_classif_multiview_paper" remains available.
        hypotheses_init_method="coarse_classif_grid",
        n_hypotheses=6,
        n_iterations=1,
        init_euler_deg_std=(15.0, 15.0, 15.0),
        init_trans_std=(0.01, 0.01, 0.05),
    )


def update_cfg_debug(cfg: TrainingConfig) -> TrainingConfig:
    """Shrink for smoke tests (run_megapose_training.py:275-287)."""
    return dataclasses.replace(
        cfg,
        n_epochs=4,
        val_epoch_interval=1,
        batch_size=4,
        epoch_size=5 * cfg.batch_size,
    )
