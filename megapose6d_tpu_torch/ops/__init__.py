"""Geometry, crops and rendering as plain torch tensor functions."""
