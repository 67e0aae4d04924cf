"""Device meshes on `torch.distributed` (the JAX package's `parallel/`)."""

from . import sharding  # noqa: F401
from .sharding import (  # noqa: F401
    gather_shards,
    local_shard,
    make_mesh,
    mesh_axis,
    pad_to_multiple,
    replicated,
    shard_observations,
)
