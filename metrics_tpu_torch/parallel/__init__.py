"""Cross-process state sync (counterpart of ``metrics_tpu/parallel/``)."""
from metrics_tpu_torch.parallel.async_sync import (
    AsyncSyncScheduler,
    SyncView,
    reset_async_sync_state,
    resolve_sync_cadence,
)
from metrics_tpu_torch.parallel.sync import (
    RetryingGather,
    class_reduce,
    distributed_available,
    fused_sync,
    gather_all_arrays,
    reduce,
    set_gather_transport,
    sync_leaf,
    sync_sketch_state,
    sync_state,
)

__all__ = [
    "AsyncSyncScheduler",
    "RetryingGather",
    "SyncView",
    "class_reduce",
    "distributed_available",
    "fused_sync",
    "gather_all_arrays",
    "reduce",
    "reset_async_sync_state",
    "resolve_sync_cadence",
    "set_gather_transport",
    "sync_leaf",
    "sync_sketch_state",
    "sync_state",
]
