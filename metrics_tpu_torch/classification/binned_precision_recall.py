"""Binned (constant-memory) precision-recall metrics (counterpart of
``metrics_tpu/classification/binned_precision_recall.py``).

Three float32 ``(C, T)`` sum states count TP/FP/FN per (class, threshold).
The counts come from ``ops/binned_counters.py``: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors. The device of the metric
decides; there is no switch between the two.
"""
from typing import Any, List, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute_with_precision_recall,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.binned_counters import binned_counter_update, threshold_order
from metrics_tpu_torch.utilities.data import METRIC_EPS, jax_linspace, to_onehot

Tensor = torch.Tensor


def _recall_at_precision(
    precision: Tensor,
    recall: Tensor,
    thresholds: Tensor,
    min_precision: float,
) -> Tuple[Tensor, Tensor]:
    """Highest recall subject to a precision floor, ties broken by precision,
    then threshold. Reduces over the last axis, so ``(C, T+1)`` curves give
    ``(C,)`` results."""
    n = thresholds.shape[-1]
    prec = precision[..., :n]
    rec = recall[..., :n]
    neg_inf = torch.tensor(float("-inf"), dtype=rec.dtype, device=rec.device)
    mask = prec >= min_precision
    r_max = torch.amax(torch.where(mask, rec, neg_inf), dim=-1, keepdim=True)
    mask2 = mask & (rec == r_max)
    p_max = torch.amax(torch.where(mask2, prec, neg_inf), dim=-1, keepdim=True)
    mask3 = mask2 & (prec == p_max)
    t_best = torch.amax(torch.where(mask3, thresholds.to(rec.dtype), neg_inf), dim=-1)

    any_valid = torch.any(mask, dim=-1)
    max_recall = torch.where(any_valid, r_max.squeeze(-1), 0.0).to(recall.dtype)
    best_threshold = torch.where(any_valid, t_best, 0.0)
    best_threshold = torch.where(max_recall == 0.0, 1e6, best_threshold)
    return max_recall, best_threshold.to(thresholds.dtype)


class BinnedPrecisionRecallCurve(Metric):
    """Constant-memory PR curve over fixed thresholds.

    ``thresholds`` is a count (evenly spaced over [0, 1], the float32 values of
    ``jnp.linspace``), a list of floats or a tensor; they may be in any order.

    Example (binary case):
        >>> import torch
        >>> pred = torch.tensor([0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> pr_curve = BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device='cpu')
        >>> precision, recall, thresholds = pr_curve(pred, target)
        >>> precision.round(decimals=2)
        tensor([0.5000, 0.5000, 1.0000, 1.0000, 1.0000, 1.0000])
        >>> recall.round(decimals=2)
        tensor([1.0000, 0.5000, 0.5000, 0.5000, 0.0000, 0.0000])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, Tensor, List[float]] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            self.num_thresholds = thresholds
            self.thresholds = jax_linspace(0, 1.0, thresholds, device=self.device)
        elif thresholds is not None:
            if not isinstance(thresholds, (list, Tensor)):
                raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
            self.thresholds = torch.tensor(thresholds, dtype=torch.float32) if isinstance(thresholds, list) else thresholds
            self.thresholds = self.thresholds.to(device=self.device, dtype=torch.float32)
            self.num_thresholds = self.thresholds.numel()
        # the thresholds are fixed: their sorted order, for the CUDA kernel, is taken once
        self._threshold_order = threshold_order(self.thresholds)

        for name in ("TPs", "FPs", "FNs"):
            self.add_state(
                name=name,
                default=torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32),
                dist_reduce_fx="sum",
            )

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds)
        target = torch.as_tensor(target)
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)
        if preds.ndim == target.ndim + 1:
            target = to_onehot(target, num_classes=self.num_classes)
        tps, fps, fns = binned_counter_update(preds, target == 1, self.thresholds, self._threshold_order)
        self.TPs += tps
        self.FPs += fps
        self.FNs += fns

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)
        ones = torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=precisions.device)
        precisions = torch.cat([precisions, ones], dim=1)
        recalls = torch.cat([recalls, torch.zeros_like(ones)], dim=1)
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Constant-memory average precision, one value per class (a list when
    ``num_classes > 1``).

    Example:
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3], dtype=torch.float32)
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> print(f"{BinnedAveragePrecision(num_classes=1, thresholds=10, device='cpu')(pred, target):.4f}")
        1.0000
    """

    def compute(self) -> Union[List[Tensor], Tensor]:
        precisions, recalls, _ = super().compute()
        return _average_precision_compute_with_precision_recall(precisions, recalls, self.num_classes, average=None)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """Highest recall at a minimum precision, and its threshold.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0, 0.2, 0.5, 0.8])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> m = BinnedRecallAtFixedPrecision(num_classes=1, thresholds=10, min_precision=0.5, device='cpu')
        >>> recall, threshold = m(pred, target)
        >>> print(f"{recall:.4f} {threshold:.4f}")
        1.0000 0.1111
    """

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, Tensor, List[float]] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, **kwargs)
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precisions, recalls, thresholds = super().compute()
        if self.num_classes == 1:
            return _recall_at_precision(precisions, recalls, thresholds, self.min_precision)
        return _recall_at_precision(torch.stack(precisions), torch.stack(recalls), thresholds[0], self.min_precision)
