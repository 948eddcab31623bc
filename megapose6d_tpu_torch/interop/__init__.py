"""Bridges from the JAX package's checkpoints and run configs, and from the
reference's PyTorch checkpoints."""

from .torch_convert import change_keys_of_older_models, load_torch_pose_checkpoint  # noqa: F401
