"""Shared helpers (counterpart of ``metrics_tpu/utilities/``)."""
