"""Serving (counterpart of ``metrics_tpu/serving/``).

A thread-safe serving loop with overload shedding, and the warmup that
captures its update graphs.

See :mod:`metrics_tpu_torch.serving.loop` (replicas confined to their
workers, merged reads, shed on a full queue) and
:mod:`metrics_tpu_torch.serving.warmup` (``ServeLoop(warmup=Warmup(...))``).
"""
from metrics_tpu_torch.serving.loop import ServeLoop
from metrics_tpu_torch.serving.warmup import (
    AOTDispatcher,
    Warmup,
    WarmupEngine,
    configure_compile_cache,
    warmup_enabled,
)

__all__ = [
    "ServeLoop",
    "Warmup",
    "WarmupEngine",
    "AOTDispatcher",
    "configure_compile_cache",
    "warmup_enabled",
]
