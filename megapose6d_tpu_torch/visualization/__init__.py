"""Visualization: detections, pose overlays, image grids and the HTML scene viewer."""
