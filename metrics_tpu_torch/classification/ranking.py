"""``CoverageError``, ``LabelRankingAveragePrecision`` and
``LabelRankingLoss`` (counterpart of ``metrics_tpu/classification/ranking.py``)."""
from typing import Any, Callable, Optional

import torch

from metrics_tpu_torch.functional.classification.ranking import (
    _coverage_error_compute,
    _coverage_error_update,
    _label_ranking_average_precision_compute,
    _label_ranking_average_precision_update,
    _label_ranking_loss_compute,
    _label_ranking_loss_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class _RankingBase(Metric):
    """A float32 score sum, an int32 row count and a float32 weight sum;
    the weight divides at ``compute()`` once an update has passed a
    ``sample_weight`` in this process."""

    is_differentiable = False
    higher_is_better: Optional[bool] = None
    full_state_update = False

    _update_fn: Callable
    _compute_fn: Callable

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("score", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("sample_weight", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self._weighted = False

    def update(self, preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
        score, total, sw = type(self)._update_fn(preds, target, sample_weight)
        self.score = score + self.score
        self.total = total + self.total
        if sw is not None:
            self._weighted = True
            self.sample_weight = sw + self.sample_weight

    def compute(self) -> Tensor:
        return type(self)._compute_fn(self.score, self.total, self.sample_weight if self._weighted else None)


class CoverageError(_RankingBase):
    """How far down the ranking one must go to cover every relevant label.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.1, 0.9, 0.3]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> metric = CoverageError(device="cpu")
        >>> round(float(metric(preds, target)), 4)
        1.5
    """

    higher_is_better = False
    _update_fn = staticmethod(_coverage_error_update)
    _compute_fn = staticmethod(_coverage_error_compute)


class LabelRankingAveragePrecision(_RankingBase):
    """The mean share of relevant labels ranked at or above each relevant
    label.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.1, 0.9, 0.3]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> metric = LabelRankingAveragePrecision(device="cpu")
        >>> round(float(metric(preds, target)), 4)
        1.0
    """

    higher_is_better = True
    _update_fn = staticmethod(_label_ranking_average_precision_update)
    _compute_fn = staticmethod(_label_ranking_average_precision_compute)


class LabelRankingLoss(_RankingBase):
    """The mean share of wrongly ordered (relevant, irrelevant) label pairs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.1, 0.9, 0.3]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> metric = LabelRankingLoss(device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.0
    """

    higher_is_better = False
    _update_fn = staticmethod(_label_ranking_loss_update)
    _compute_fn = staticmethod(_label_ranking_loss_compute)
