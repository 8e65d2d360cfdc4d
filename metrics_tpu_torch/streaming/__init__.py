"""Streaming sketches (counterpart of ``metrics_tpu/streaming/``)."""
from metrics_tpu_torch.streaming.sketches import (
    CountMinSketch,
    CountMinState,
    HllState,
    HyperLogLog,
    QuantileSketch,
    QuantileSketchState,
)

__all__ = [
    "CountMinSketch",
    "CountMinState",
    "HllState",
    "HyperLogLog",
    "QuantileSketch",
    "QuantileSketchState",
]
