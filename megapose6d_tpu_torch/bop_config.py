"""Per-BOP-dataset configuration: the port's copy of the tables of
`megapose6d_tpu/bop_config.py`.

Input resolutions and dataset names for each BOP challenge dataset, and
per-dataset run-directory slots for trained models.
"""

from __future__ import annotations

BOP_CONFIG: dict[str, dict] = {}

BOP_CONFIG["hb"] = dict(
    input_resize=(480, 640),
    obj_ds_name="hb",
    train_pbr_ds_name=["hb.pbr"],
    inference_ds_name=["hb.bop19"],
    test_ds_name=[],
)
BOP_CONFIG["icbin"] = dict(
    input_resize=(480, 640),
    obj_ds_name="icbin",
    train_pbr_ds_name=["icbin.pbr"],
    inference_ds_name=["icbin.bop19"],
    test_ds_name=["icbin.bop19"],
)
BOP_CONFIG["itodd"] = dict(
    input_resize=(960, 1280),
    obj_ds_name="itodd",
    train_pbr_ds_name=["itodd.pbr"],
    inference_ds_name=["itodd.bop19"],
    test_ds_name=[],
)
BOP_CONFIG["lmo"] = dict(
    input_resize=(480, 640),
    obj_ds_name="lm",
    train_pbr_ds_name=["lm.pbr"],
    inference_ds_name=["lmo.bop19"],
    test_ds_name=["lmo.bop19"],
)
BOP_CONFIG["lm"] = dict(
    input_resize=(480, 640),
    obj_ds_name="lm",
    train_pbr_ds_name=["lm.pbr"],
    inference_ds_name=["lm.bop19"],
    test_ds_name=["lm.bop19"],
)
BOP_CONFIG["tless"] = dict(
    input_resize=(540, 720),
    obj_ds_name="tless.cad",
    train_pbr_ds_name=["tless.pbr"],
    inference_ds_name=["tless.bop19"],
    test_ds_name=["tless.bop19"],
)
BOP_CONFIG["tudl"] = dict(
    input_resize=(480, 640),
    obj_ds_name="tudl",
    train_pbr_ds_name=["tudl.pbr"],
    inference_ds_name=["tudl.bop19"],
    test_ds_name=["tudl.bop19"],
)
BOP_CONFIG["ycbv"] = dict(
    input_resize=(480, 640),
    obj_ds_name="ycbv",
    train_pbr_ds_name=["ycbv.pbr"],
    inference_ds_name=["ycbv.bop19"],
    test_ds_name=["ycbv.bop19"],
)

# Run-dir slots for per-dataset trained models (the reference's
# PBR_COARSE/PBR_REFINER/PBR_DETECTORS run-id tables).
PBR_COARSE: dict[str, str] = {}
PBR_REFINER: dict[str, str] = {}
PBR_DETECTORS: dict[str, str] = {}
