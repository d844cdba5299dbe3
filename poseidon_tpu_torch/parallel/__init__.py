"""Process identity, barriers and object broadcast over ``torch.distributed``."""

from .host import broadcast_object, is_primary, process_count, process_index, sync_hosts

__all__ = ["broadcast_object", "is_primary", "process_count", "process_index", "sync_hosts"]
