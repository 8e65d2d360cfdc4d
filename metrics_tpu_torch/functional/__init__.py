"""Functional metrics (counterpart of ``metrics_tpu/functional/``)."""
