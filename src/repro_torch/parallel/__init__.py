"""Scale-out layouts: the reference's sharding rules as pure functions
(``sharding``) and the tensor-parallel engine's shards and collectives
(``tp``)."""

from .sharding import (batch_axes, batch_specs, cache_specs, mesh_axes,
                       paged_pool_specs, param_specs, shard_tree)
from .tp import TPGroup, tp_engine_parts

__all__ = ["mesh_axes", "batch_axes", "param_specs", "cache_specs", "paged_pool_specs",
           "batch_specs", "shard_tree", "TPGroup", "tp_engine_parts"]
