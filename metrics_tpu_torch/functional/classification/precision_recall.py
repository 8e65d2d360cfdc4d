"""Counterpart of ``metrics_tpu/functional/classification/precision_recall.py``:
precision and recall."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor

_AVERAGES = ("micro", "macro", "weighted", "samples", "none", None)


def _apply_meaningless_sentinel(
    numerator: Tensor,
    denominator: Tensor,
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tuple[Tensor, Tensor]:
    """Mark a class absent from preds and target (no tp, fp or fn) with the
    ``-1`` ignore sentinel, so a macro average leaves it out and ``"none"``
    gives it NaN."""
    if average in (AverageMethod.MACRO, AverageMethod.NONE, None) and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp + fp + fn) == 0
        numerator = torch.where(meaningless, -1, numerator)
        denominator = torch.where(meaningless, -1, denominator)
    return numerator, denominator


def _precision_compute(
    tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> Tensor:
    """``tp / (tp + fp)``, averaged."""
    numerator, denominator = _apply_meaningless_sentinel(tp, tp + fp, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(
    tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> Tensor:
    """``tp / (tp + fn)``, averaged."""
    numerator, denominator = _apply_meaningless_sentinel(tp, tp + fn, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _check_average_arg(
    average: Optional[str], mdmc_average: Optional[str], num_classes: Optional[int], ignore_index: Optional[int]
) -> None:
    if average not in _AVERAGES:
        raise ValueError(f"The `average` has to be one of {_AVERAGES}, got {average}.")
    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _stat_scores_for(
    preds: Tensor,
    target: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    ignore_index: Optional[int],
    num_classes: Optional[int],
    threshold: float,
    top_k: Optional[int],
    multiclass: Optional[bool],
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The counts that ``average`` reduces: per class for macro, weighted
    and none, else as ``average`` says."""
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)
    return _stat_scores_update(
        preds,
        target,
        reduce="macro" if average in ("weighted", "none", None) else average,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def precision(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """Precision, ``TP / (TP + FP)``.

    Example:
        >>> import torch
        >>> precision(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]), average='micro')
        tensor(0.2500)
    """
    tp, fp, _, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """Recall, ``TP / (TP + FN)``.

    Example:
        >>> import torch
        >>> recall(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]), average='micro')
        tensor(0.2500)
    """
    tp, fp, _, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """Precision and recall from one pass of the counts."""
    tp, fp, _, fn = _stat_scores_for(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _precision_compute(tp, fp, fn, average, mdmc_average), _recall_compute(tp, fp, fn, average, mdmc_average)
