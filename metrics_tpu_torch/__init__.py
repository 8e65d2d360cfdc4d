"""PyTorch/CUDA port of ``metrics_tpu``.

The same metrics with the same ``update``/``compute``/``forward`` semantics
and state layouts, on PyTorch tensors. Metrics run on CUDA unless the caller
passes ``device="cpu"``; the kernels that the JAX package wrote in Pallas for
the TPU are CUDA kernels for Hopper here (``csrc/``), built on first use.
This package imports neither JAX nor ``metrics_tpu``.
"""
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.classification.accuracy import Accuracy
from metrics_tpu_torch.classification.auc import AUC
from metrics_tpu_torch.classification.auroc import AUROC
from metrics_tpu_torch.classification.avg_precision import AveragePrecision
from metrics_tpu_torch.classification.binned_precision_recall import (
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.f_beta import F1Score, FBetaScore
from metrics_tpu_torch.classification.precision_recall import Precision, Recall
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve
from metrics_tpu_torch.classification.roc import ROC
from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.guard import FaultCounters
from metrics_tpu_torch.streaming import (
    CountMinSketch,
    CountMinState,
    DecayedMetric,
    HllState,
    HyperLogLog,
    QuantileSketch,
    QuantileSketchState,
    WindowedMetric,
)
from metrics_tpu_torch.resilience.health import health_report

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CatMetric",
    "CountMinSketch",
    "CountMinState",
    "DecayedMetric",
    "F1Score",
    "FBetaScore",
    "FaultCounters",
    "HllState",
    "HyperLogLog",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "Precision",
    "PrecisionRecallCurve",
    "QuantileSketch",
    "QuantileSketchState",
    "ROC",
    "Recall",
    "StatScores",
    "SumMetric",
    "WindowedMetric",
    "health_report",
]
