"""Streaming sketches (counterpart of ``metrics_tpu/streaming/``)."""
from metrics_tpu_torch.streaming.sketches import (
    CountMinSketch,
    CountMinState,
    HllState,
    HyperLogLog,
    QuantileSketch,
    QuantileSketchState,
)
from metrics_tpu_torch.streaming.windowed import DecayedMetric, WindowedMetric

__all__ = [
    "CountMinSketch",
    "DecayedMetric",
    "CountMinState",
    "HllState",
    "HyperLogLog",
    "QuantileSketch",
    "QuantileSketchState",
    "WindowedMetric",
]
