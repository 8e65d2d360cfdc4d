"""Kernels and their plain PyTorch versions (counterpart of ``metrics_tpu/ops/``).

The histogram (K2) lives in the submodule ``ops.histogram``, whose name
its function ``histogram`` would shadow here, so it is not re-exported.
"""
from metrics_tpu_torch.ops.binned_counters import binned_counter_update, binned_counter_update_plain
from metrics_tpu_torch.ops.compactor import compactor_fold, compactor_fold_plain

__all__ = ["binned_counter_update", "binned_counter_update_plain", "compactor_fold", "compactor_fold_plain"]
