"""Specificity (counterpart of
``metrics_tpu/functional/classification/specificity.py``): TN / (TN + FP)
over the stat-scores counts."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor

_ALLOWED_AVERAGE = ("micro", "macro", "weighted", "samples", "none", None)
_ALLOWED_MDMC_AVERAGE = (None, "samplewise", "global")


def _specificity_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    """tn / (tn + fp), averaged; a class with no tp, fp or fn is marked
    absent (-1) for ``average="none"``."""
    numerator = tn
    denominator = tn + fp
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp + fp + fn) == 0
        numerator = torch.where(meaningless, -1, numerator)
        denominator = torch.where(meaningless, -1, denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tn + fp).to(torch.float32),
        average=average,
        mdmc_average=mdmc_average,
    )


def _check_average_args(
    average: Optional[str], mdmc_average: Optional[str], num_classes: Optional[int], ignore_index: Optional[int]
) -> None:
    if average not in _ALLOWED_AVERAGE:
        raise ValueError(f"The `average` has to be one of {_ALLOWED_AVERAGE}, got {average}.")
    if mdmc_average not in _ALLOWED_MDMC_AVERAGE:
        raise ValueError(f"The `mdmc_average` has to be one of {_ALLOWED_MDMC_AVERAGE}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def specificity(
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
    """Specificity = TN / (TN + FP).

    Example:
        >>> import torch
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> specificity(preds, target, average='micro')
        tensor(0.6250)
    """
    _check_average_args(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)
