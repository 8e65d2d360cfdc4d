"""Degradation records (counterpart of ``metrics_tpu/resilience/``)."""
from metrics_tpu_torch.resilience.health import HealthRegistry, health_report, record_degradation, registry

__all__ = ["HealthRegistry", "health_report", "record_degradation", "registry"]
