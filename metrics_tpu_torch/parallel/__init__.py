"""Cross-process state sync (counterpart of ``metrics_tpu/parallel/``)."""
from metrics_tpu_torch.parallel.async_sync import AsyncSyncScheduler, SyncView
from metrics_tpu_torch.parallel.sync import (
    RetryingGather,
    distributed_available,
    fused_sync,
    gather_all_arrays,
    set_gather_transport,
)

__all__ = [
    "AsyncSyncScheduler",
    "RetryingGather",
    "SyncView",
    "distributed_available",
    "fused_sync",
    "gather_all_arrays",
    "set_gather_transport",
]
