"""The Dice score (counterpart of
``metrics_tpu/functional/classification/dice.py``): 2 TP / (2 TP + FP + FN)
over the stat-scores counts."""
import math
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.specificity import _check_average_args
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utilities.checks import _input_squeeze
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _dice_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """2*tp / (2*tp + fp + fn), averaged; a class with no tp, fp or fn is
    marked absent (-1) for macro and none averages."""
    numerator = 2 * tp
    denominator = 2 * tp + fp + fn

    if average in (AverageMethod.MACRO, AverageMethod.NONE, None) and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp + fp + fn) == 0
        numerator = torch.where(meaningless, -1, numerator)
        denominator = torch.where(meaningless, -1, denominator)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn).to(torch.float32),
        average=average,
        mdmc_average=mdmc_average,
        zero_division=zero_division,
    )


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: int = 0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """The Dice score.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> dice(preds, target, average='micro')
        tensor(0.2500)
    """
    _check_average_args(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    preds, target = _input_squeeze(torch.as_tensor(preds), torch.as_tensor(target))
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
    return _dice_compute(tp, fp, fn, average, mdmc_average, zero_division)


def dice_score(
    preds: Tensor,
    target: Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Deprecated macro-Dice alias: :func:`dice` with ``average="macro"``
    and the background as ``ignore_index=0`` unless ``bg``."""
    rank_zero_warn(
        "The `dice_score` function was deprecated in v0.9 and will be removed in v0.10. Use `dice` function instead.",
        DeprecationWarning,
    )
    num_classes = preds.shape[1]
    if no_fg_score != 0.0:
        rank_zero_warn("Deprecated parameter. Switched to default `no_fg_score` = 0.0.")
    if reduction != "elementwise_mean":
        rank_zero_warn("Deprecated parameter. Switched to default `reduction` = 'elementwise_mean'.")
    zero_division = math.floor(nan_score)
    if zero_division != nan_score:
        rank_zero_warn(f"Deprecated parameter. `nan_score` converted to integer {zero_division}.")
    return dice(
        preds,
        target,
        ignore_index=None if bg else 0,
        average="macro",
        num_classes=num_classes,
        zero_division=zero_division,
    )
