"""Functional classification metrics (counterpart of ``metrics_tpu/functional/classification/``)."""
from metrics_tpu_torch.functional.classification.accuracy import accuracy
from metrics_tpu_torch.functional.classification.auc import auc
from metrics_tpu_torch.functional.classification.auroc import auroc
from metrics_tpu_torch.functional.classification.average_precision import average_precision
from metrics_tpu_torch.functional.classification.f_beta import f1_score, fbeta_score
from metrics_tpu_torch.functional.classification.precision_recall import precision, precision_recall, recall
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores

__all__ = [
    "accuracy",
    "auc",
    "auroc",
    "average_precision",
    "f1_score",
    "fbeta_score",
    "precision",
    "precision_recall",
    "precision_recall_curve",
    "recall",
    "roc",
    "stat_scores",
]
