from .mesh import make_mesh, shard_batch, run_transient_sharded

__all__ = ["make_mesh", "shard_batch", "run_transient_sharded"]
