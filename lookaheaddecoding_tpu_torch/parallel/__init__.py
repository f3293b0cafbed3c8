"""Tensor, pipeline, lookahead and data parallelism on
``torch.distributed``: the mesh and the sharding (``sharding``), the
collectives the forward and the train step call (``collectives``) and a
launcher of a world of ranks (``launch``)."""

from .sharding import (Mesh, kv_cache_spec, make_mesh, make_multihost_mesh,
                       param_specs, shard_params)

__all__ = ["Mesh", "kv_cache_spec", "make_mesh", "make_multihost_mesh",
           "param_specs", "shard_params"]
