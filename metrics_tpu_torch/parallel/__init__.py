"""Cross-process state sync (counterpart of ``metrics_tpu/parallel/``)."""
from metrics_tpu_torch.parallel.sync import distributed_available, fused_sync, gather_all_arrays

__all__ = ["distributed_available", "fused_sync", "gather_all_arrays"]
