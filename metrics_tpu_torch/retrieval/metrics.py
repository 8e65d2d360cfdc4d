"""The retrieval metrics (counterpart of ``metrics_tpu/retrieval/metrics.py``).

Each class names its masked row kernel (``functional/retrieval/kernels.py``);
:class:`~metrics_tpu_torch.retrieval.base.RetrievalMetric` groups the rows and
averages. The precision/recall curve and the recall at a fixed precision
compute a ``(max_k,)`` curve per query in both modes.
"""
from typing import Any, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.functional.retrieval.kernels import (
    _masked_average_precision,
    _masked_fall_out,
    _masked_hit_rate,
    _masked_normalized_dcg,
    _masked_precision,
    _masked_precision_recall_curve,
    _masked_r_precision,
    _masked_recall,
    _masked_reciprocal_rank,
)
from metrics_tpu_torch.retrieval.base import RetrievalMetric, _grouped

Tensor = torch.Tensor


def _check_k(k: Optional[int], name: str = "k") -> None:
    if (k is not None) and not (isinstance(k, int) and k > 0):
        raise ValueError(f"`{name}` has to be a positive integer or None")


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over the queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMAP
        >>> metric = RetrievalMAP(device="cpu")
        >>> metric.update(torch.tensor([0.8, 0.4, 0.9, 0.2]), torch.tensor([1, 0, 0, 1]),
        ...               indexes=torch.tensor([0, 0, 1, 1]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _masked_average_precision(preds, target, mask)


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank over the queries."""

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _masked_reciprocal_rank(preds, target, mask)


class RetrievalPrecision(RetrievalMetric):
    """Mean precision@k; ``adaptive_k`` cuts ``k`` to a shorter query's
    length."""

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        adaptive_k: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.k = k
        self.adaptive_k = adaptive_k

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _masked_precision(preds, target, mask, k=self.k, adaptive_k=self.adaptive_k)


class RetrievalRecall(RetrievalMetric):
    """Mean recall@k."""

    def __init__(
        self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(k)
        self.k = k

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _masked_recall(preds, target, mask, k=self.k)


class RetrievalFallOut(RetrievalMetric):
    """Mean fall-out@k. A query without a non-relevant document is the
    degenerate one here."""

    higher_is_better = False

    def __init__(
        self, empty_target_action: str = "pos", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(k)
        self.k = k

    def _query_is_empty(self, pos_counts: Any, neg_counts: Any) -> Any:
        return neg_counts == 0

    def _empty_message(self) -> str:
        return "`compute` method was provided with a query with no negative target."

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _masked_fall_out(preds, target, mask, k=self.k)


class RetrievalNormalizedDCG(RetrievalMetric):
    """Mean nDCG@k; graded relevance allowed."""

    def __init__(
        self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(k)
        self.k = k
        self.allow_non_binary_target = True

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _masked_normalized_dcg(preds, target, mask, k=self.k)


class RetrievalHitRate(RetrievalMetric):
    """Mean hit rate@k."""

    def __init__(
        self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(k)
        self.k = k

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _masked_hit_rate(preds, target, mask, k=self.k)


class RetrievalRPrecision(RetrievalMetric):
    """Mean R-precision."""

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        return _masked_r_precision(preds, target, mask)


def _retrieval_recall_at_fixed_precision(
    precision: Tensor, recall: Tensor, top_k: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """The best recall whose precision reaches ``min_precision``, and its
    ``k`` (the largest ``k`` among ties); without one, or when that recall
    is 0, recall 0 and ``k = len(top_k)``."""
    n = top_k.shape[0]
    meets = precision >= min_precision
    any_meets = meets.any()
    r_star = torch.where(meets, recall, torch.full_like(recall, float("-inf"))).max()
    best_k = torch.where(meets & (recall == r_star), top_k, torch.zeros_like(top_k)).max()
    max_recall = torch.where(any_meets, r_star, torch.zeros_like(r_star)).to(torch.float32)
    best_k = torch.where(any_meets & (r_star > 0), best_k, torch.full_like(best_k, n)).to(top_k.dtype)
    return max_recall, best_k


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """The query-averaged precision and recall at every ``k`` up to
    ``max_k``. Without ``max_k`` it is the longest query's length in the
    list mode and ``max_docs_per_query`` in the capacity mode."""

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(max_k, "max_k")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:  # pragma: no cover - unused
        raise NotImplementedError

    def _curve_kernel(self, max_k: int):
        def kernel(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
            return torch.stack(_masked_precision_recall_curve(preds, target, mask, max_k, self.adaptive_k), dim=1)

        return kernel

    def _compute_capacity(self) -> Tuple[Tensor, Tensor, Tensor]:
        max_k = self.max_k if self.max_k is not None else self.max_docs_per_query
        pmat, tmat, mask = self._grouped_capacity_matrices()
        curves = self._curve_kernel(max_k)(pmat, tmat, mask)  # (Q, 2, max_k)
        blank, include, fill = self._capacity_masks(tmat, mask)
        curves = torch.where(blank[:, None, None], torch.full_like(curves, fill), curves)
        denom = torch.clamp_min(include.sum(), 1)
        mean = (curves * include[:, None, None].to(curves.dtype)).sum(dim=0) / denom
        top_k = torch.arange(1, max_k + 1, dtype=torch.int32, device=mean.device)
        return mean[0], mean[1], top_k

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        if self.capacity is not None:
            return self._compute_capacity()
        indexes, preds, target = self._list_rows()
        layout = _grouped(indexes, preds, target) if indexes.numel() else None
        max_k = self.max_k
        if max_k is None:
            max_k = int(np.max(layout.counts)) if layout is not None else 1
        top_k = torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)
        values = (
            self._values_over(layout, self._curve_kernel(max_k), (2, max_k))
            if layout is not None
            else torch.zeros((0, 2, max_k), device=preds.device)
        )
        if values.shape[0] == 0:
            return torch.zeros(max_k, device=preds.device), torch.zeros(max_k, device=preds.device), top_k
        return values[:, 0].mean(dim=0), values[:, 1].mean(dim=0), top_k


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The best recall@k whose precision reaches ``min_precision``, and its
    ``k``."""

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k, adaptive_k=adaptive_k, empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs
        )
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precision, recall, top_k = super().compute()
        return _retrieval_recall_at_fixed_precision(precision, recall, top_k, self.min_precision)
