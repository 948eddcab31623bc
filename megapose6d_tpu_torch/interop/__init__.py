"""Bridges from the JAX package's checkpoints and run configs."""
