"""Per-cohort metrics from one update (counterpart of
``metrics_tpu/sliced/__init__.py``; ``slicing.py`` has the state layout,
the quarantine and discard rows, and the scrape's label cap)."""
from metrics_tpu_torch.sliced.slicing import (
    SlicedMetric,
    SlicedValue,
    reset_sliced_state,
    slices_max_labels,
)

__all__ = ["SlicedMetric", "SlicedValue", "slices_max_labels", "reset_sliced_state"]
