"""Crash-safe elastic snapshots and degradation records (counterpart of
``metrics_tpu/resilience/``)."""
from metrics_tpu_torch.resilience.health import HealthRegistry, health_report, record_degradation, registry
from metrics_tpu_torch.resilience.snapshot import (
    SnapshotCorruptionError,
    SnapshotError,
    SnapshotManager,
    SnapshotSchemaError,
)

__all__ = [
    "HealthRegistry",
    "SnapshotCorruptionError",
    "SnapshotError",
    "SnapshotManager",
    "SnapshotSchemaError",
    "health_report",
    "record_degradation",
    "registry",
]
