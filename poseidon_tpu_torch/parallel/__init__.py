"""Processes, the (data, model) mesh and its sharding rules over
``torch.distributed``."""

from .host import (broadcast_object, initialize_distributed, is_primary, process_count,
                   process_index, sync_hosts)
from .mesh import assert_opt_state_sharded, make_mesh, param_partition_spec, shard_batch

__all__ = ["broadcast_object", "initialize_distributed", "is_primary", "process_count",
           "process_index", "sync_hosts", "assert_opt_state_sharded", "make_mesh",
           "param_partition_spec", "shard_batch"]
