"""Several devices: process groups and collectives (`distributed`), and a
device list that one process splits a batch over (`mesh`)."""

from .mesh import batch_sharding, make_mesh, shard_batch  # noqa: F401
