"""PyTorch/CUDA port of ``metrics_tpu``.

The same metrics with the same ``update``/``compute``/``forward`` semantics
and state layouts, on PyTorch tensors. Metrics run on CUDA unless the caller
passes ``device="cpu"``; the kernels that the JAX package wrote in Pallas for
the TPU are CUDA kernels for Hopper here (``csrc/``), built on first use.
This package imports neither JAX nor ``metrics_tpu``.
"""
from metrics_tpu_torch.classification.accuracy import Accuracy
from metrics_tpu_torch.classification.auc import AUC
from metrics_tpu_torch.classification.auroc import AUROC
from metrics_tpu_torch.classification.avg_precision import AveragePrecision
from metrics_tpu_torch.classification.binned_precision_recall import (
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve
from metrics_tpu_torch.classification.roc import ROC
from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.streaming import (
    CountMinSketch,
    CountMinState,
    HllState,
    HyperLogLog,
    QuantileSketch,
    QuantileSketchState,
)

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CountMinSketch",
    "CountMinState",
    "HllState",
    "HyperLogLog",
    "Metric",
    "MetricCollection",
    "PrecisionRecallCurve",
    "QuantileSketch",
    "QuantileSketchState",
    "ROC",
    "StatScores",
]
