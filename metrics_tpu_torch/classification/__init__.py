"""Module metrics for classification (counterpart of ``metrics_tpu/classification/``)."""
