"""Visualization: detections, pose overlays, image grids and the HTML scene viewer."""

from .plotter import plot_detections, plot_pose_overlay, save_image_grid  # noqa: F401
