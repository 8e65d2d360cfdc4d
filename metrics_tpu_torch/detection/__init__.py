"""Detection metrics (counterpart of ``metrics_tpu/detection/``)."""
from metrics_tpu_torch.detection.mean_ap import MeanAveragePrecision  # noqa: F401
