"""Paths from the environment, as `megapose6d_tpu/config.py`.

`MEGAPOSE_DATA_DIR` points at the local data root with the reference's
layout; the port reads bop_datasets/ and webdatasets/.
"""

from __future__ import annotations

import os
from pathlib import Path

LOCAL_DATA_DIR = Path(os.environ.get("MEGAPOSE_DATA_DIR", Path.home() / "megapose_data"))
BOP_DS_DIR = LOCAL_DATA_DIR / "bop_datasets"
WDS_DS_DIR = LOCAL_DATA_DIR / "webdatasets"
