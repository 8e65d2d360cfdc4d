"""Functional retrieval metrics (counterpart of
``metrics_tpu/functional/retrieval/__init__.py``).

Each function takes one query's 1-D ``(preds, target)`` pair; the module
metrics (``metrics_tpu_torch/retrieval``) group rows by query id and average
the per-query values.
"""
from metrics_tpu_torch.functional.retrieval.kernels import (
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_precision_recall_curve,
    retrieval_r_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)

__all__ = [
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
