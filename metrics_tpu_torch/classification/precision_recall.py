"""Counterpart of ``metrics_tpu/classification/precision_recall.py``:
``Precision`` and ``Recall``."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import (
    _AVERAGES,
    _precision_compute,
    _recall_compute,
)

Tensor = torch.Tensor


class _AveragedStatScores(StatScores):
    """The stat-scores states that an ``average`` reduces: per class for
    macro, weighted and none, else as ``average`` says."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        if average not in _AVERAGES:
            raise ValueError(f"The `average` has to be one of {_AVERAGES}, got {average}.")
        super().__init__(
            reduce="macro" if average in ("weighted", "none", None) else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )
        self.average = average


class Precision(_AveragedStatScores):
    """Precision, ``TP / (TP + FP)``.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.05, 0.15], [0.1, 0.15, 0.7, 0.05],
        ...                       [0.3, 0.4, 0.2, 0.1], [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> Precision(num_classes=4, average='macro', device='cpu')(preds, target)
        tensor(0.2500)
    """

    def compute(self) -> Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)


class Recall(_AveragedStatScores):
    """Recall, ``TP / (TP + FN)``.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.05, 0.15], [0.1, 0.15, 0.7, 0.05],
        ...                       [0.3, 0.4, 0.2, 0.1], [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> Recall(num_classes=4, average='macro', device='cpu')(preds, target)
        tensor(0.2500)
    """

    def compute(self) -> Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)
