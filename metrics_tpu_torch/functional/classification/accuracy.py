"""Accuracy (counterpart of ``metrics_tpu/functional/classification/accuracy.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utilities.checks import _check_classification_inputs, _input_format_classification, _input_squeeze
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType, MDMCAverageMethod

Tensor = torch.Tensor


def _check_subset_validity(mode: DataType) -> bool:
    return mode in (DataType.MULTILABEL, DataType.MULTIDIM_MULTICLASS)


def _mode(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int] = None,
) -> DataType:
    """Resolve the input case."""
    return _check_classification_inputs(
        torch.as_tensor(preds),
        torch.as_tensor(target),
        threshold=threshold,
        top_k=top_k,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def _accuracy_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str],
    mdmc_reduce: Optional[str],
    threshold: float,
    num_classes: Optional[int],
    top_k: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int],
    mode: DataType,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")
    preds, target = _input_squeeze(torch.as_tensor(preds), torch.as_tensor(target))
    return _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
        mode=mode,
        valid=valid,
    )


def _accuracy_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    mode: DataType,
) -> Tensor:
    """Absent classes are dropped (macro) or NaN (none) through the ignore sentinel."""
    simple_average = (AverageMethod.MICRO, AverageMethod.SAMPLES)
    if (mode == DataType.BINARY and average in simple_average) or mode == DataType.MULTILABEL:
        numerator = tp + tn
        denominator = tp + tn + fp + fn
    else:
        numerator = tp
        denominator = tp + fn

    if mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        if average in (AverageMethod.MACRO, AverageMethod.NONE, None):
            meaningless = (tp + fp + fn) == 0
            numerator = torch.where(meaningless, -1, numerator)
            denominator = torch.where(meaningless, -1, denominator)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _subset_accuracy_update(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Exact-match counting."""
    preds, target = _input_squeeze(torch.as_tensor(preds), torch.as_tensor(target))
    preds, target, mode = _input_format_classification(
        preds, target, threshold=threshold, top_k=top_k, ignore_index=ignore_index
    )

    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")

    if mode == DataType.MULTILABEL:
        correct = torch.sum(torch.all(preds == target, dim=1))
        total = torch.tensor(target.shape[0], device=target.device)
    elif mode == DataType.MULTICLASS:
        correct = torch.sum(preds * target)
        total = torch.sum(target)
    elif mode == DataType.MULTIDIM_MULTICLASS:
        sample_correct = torch.sum(preds * target, dim=(1, 2))
        correct = torch.sum(sample_correct == target.shape[2])
        total = torch.tensor(target.shape[0], device=target.device)
    else:
        correct = torch.tensor(0, device=target.device)
        total = torch.tensor(0, device=target.device)

    return correct.to(torch.int32), total.to(torch.int32)


def _subset_accuracy_compute(correct: Tensor, total: Tensor) -> Tensor:
    return correct.to(torch.float32) / total


def accuracy(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    subset_accuracy: bool = False,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Accuracy over any classification input type.

    Example:
        >>> import torch
        >>> accuracy(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))
        tensor(0.5000)
    """
    allowed_average = (AverageMethod.MICRO, AverageMethod.MACRO, AverageMethod.WEIGHTED, AverageMethod.SAMPLES, AverageMethod.NONE, None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

    if average in (AverageMethod.MACRO, AverageMethod.WEIGHTED, AverageMethod.NONE) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")

    allowed_mdmc_average = (None, MDMCAverageMethod.SAMPLEWISE, MDMCAverageMethod.GLOBAL)
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")

    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    preds, target = _input_squeeze(torch.as_tensor(preds), torch.as_tensor(target))
    mode = _mode(preds, target, threshold, top_k, num_classes, multiclass, ignore_index)
    reduce = "macro" if average in (AverageMethod.WEIGHTED, AverageMethod.NONE, None) else average

    if subset_accuracy and _check_subset_validity(mode):
        correct, total = _subset_accuracy_update(preds, target, threshold, top_k, ignore_index)
        return _subset_accuracy_compute(correct, total)
    tp, fp, tn, fn = _accuracy_update(
        preds, target, reduce, mdmc_average, threshold, num_classes, top_k, multiclass, ignore_index, mode
    )
    return _accuracy_compute(tp, fp, tn, fn, average, mdmc_average, mode)
