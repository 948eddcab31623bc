"""Geometry, crops and rendering as plain torch tensor functions."""

from . import (  # noqa: F401
    camera,
    cropping,
    losses,
    mesh_ops,
    multiview,
    pose_init,
    se3,
    so3_grid,
    symmetries,
)
