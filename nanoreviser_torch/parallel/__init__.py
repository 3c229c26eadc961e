from .mesh import Mesh, all_reduce_sum, choose_backend, make_mesh, shard_params

__all__ = ["Mesh", "all_reduce_sum", "choose_backend", "make_mesh", "shard_params"]
