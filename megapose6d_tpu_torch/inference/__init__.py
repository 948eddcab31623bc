"""Inference API: PoseEstimator and its configuration."""
