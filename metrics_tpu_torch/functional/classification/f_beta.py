"""Counterpart of ``metrics_tpu/functional/classification/f_beta.py``:
F-beta and F1.

Classes that take no part are marked with the ``-1`` ignore sentinel and
left out by masked sums, as in the JAX package: a micro average sums the
classes whose counts are not the sentinel, ``average="none"`` gives NaN to
a class absent from preds and target, and ``ignore_index`` marks its class.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.precision_recall import _stat_scores_for
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utilities.compute import _safe_divide
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor


def _masked_sum(x: Tensor, mask: Tensor) -> Tensor:
    return torch.sum(torch.where(mask, x, 0))


def _fbeta_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    """F-beta from the counts."""
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        mask = tp >= 0  # leave out classes carrying the macro ignore sentinel
        tp_s, fp_s, fn_s = _masked_sum(tp, mask), _masked_sum(fp, mask), _masked_sum(fn, mask)
        precision = _safe_divide(tp_s, tp_s + fp_s)
        recall = _safe_divide(tp_s, tp_s + fn_s)
    else:
        precision = _safe_divide(tp, tp + fp)
        recall = _safe_divide(tp, tp + fn)

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, 1.0, denom)

    # a class absent from preds and target has no score
    sentinel = None
    classes = torch.arange(tp.shape[-1], device=tp.device) if tp.ndim else None
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        sentinel = (tp + fp + fn) == 0
        if ignore_index is not None:
            sentinel = sentinel | (classes == ignore_index)
    elif ignore_index is not None:
        if average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
            sentinel = classes == ignore_index
            if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
                sentinel = torch.broadcast_to(sentinel, num.shape)

    if sentinel is not None:
        num = torch.where(sentinel, -1, num)
        denom = torch.where(sentinel, -1, denom)

    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = ((tp + fp + fn) == 0) | ((tp + fp + fn) == -3)
        num = torch.where(cond, -1, num)
        denom = torch.where(cond, -1, denom)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn).to(torch.float32),
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F-beta score.

    Example:
        >>> import torch
        >>> fbeta_score(torch.tensor([0, 2, 1, 0, 0, 1]), torch.tensor([0, 1, 2, 0, 1, 2]), beta=0.5)
        tensor(0.3333)
    """
    tp, fp, tn, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1_score(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F1, F-beta with beta 1. ``beta`` is taken, third as in F-beta, and
    ignored, as the JAX package ignores it.

    Example:
        >>> import torch
        >>> f1_score(torch.tensor([0, 2, 1, 0, 0, 1]), torch.tensor([0, 1, 2, 0, 1, 2]))
        tensor(0.3333)
    """
    return fbeta_score(preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
