"""Average precision (counterpart of
``metrics_tpu/functional/classification/average_precision.py``)."""
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.masked_common import masked_curve_prologue
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utilities.data import _bincount

Tensor = torch.Tensor


def _binary_average_precision_masked(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """Average precision of the masked rows, in fixed shapes: the PR curve's
    step integral on the valid rows, ``sum over tie groups of precision at
    the group's end * positives in the group / n_pos``. No positives give
    NaN."""
    parts = masked_curve_prologue(preds, target, mask)
    tps, boundary, n_pos = parts.tps, parts.boundary, parts.n_pos
    precision = tps / torch.clamp(parts.kv, min=1.0)

    # positives in each group: tps at this boundary minus tps at the one
    # before; tps rises, so a shifted running max of the boundaries' tps
    # gives the one before
    marked = torch.where(boundary, tps, 0.0)
    prev = torch.cat([torch.zeros(1, device=tps.device), torch.cummax(marked, 0).values[:-1]])
    group_pos = tps - prev

    ap = torch.sum(torch.where(boundary, precision * group_pos, 0.0)) / torch.clamp(n_pos, min=1.0)
    return torch.where(n_pos > 0, ap, float("nan"))


def _multiclass_average_precision_masked(
    preds: Tensor,
    target: Tensor,
    mask: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
) -> Tensor:
    """One-vs-rest masked AP over a ``(cap, C)`` score buffer; ``micro`` is
    refused for multiclass input."""
    if average == "micro":
        raise ValueError("Cannot use `micro` average with multi-class input")
    per_class = torch.stack(
        [_binary_average_precision_masked(preds[:, c], (target == c).to(torch.int32), mask) for c in range(num_classes)]
    )
    if average in (None, "none"):
        return per_class
    defined = ~torch.isnan(per_class)
    safe = torch.where(defined, per_class, 0.0)
    if average == "macro":
        return torch.sum(safe) / torch.clamp(torch.sum(defined.to(torch.float32)), min=1.0)
    if average == "weighted":
        # rows left out go to an extra bin, which is cut off
        counts = _bincount(torch.where(mask.to(torch.bool), target, num_classes), minlength=num_classes + 1)
        weights = torch.where(defined, counts[:num_classes].to(torch.float32), 0.0)
        return torch.sum(safe * weights / torch.clamp(torch.sum(weights), min=1.0))
    raise ValueError(f"Average {average!r} is not supported in masked AP")


def _average_precision_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    if average == "micro" and preds.ndim != target.ndim:
        raise ValueError("Cannot use `micro` average with multi-class input")
    return preds, target, num_classes, pos_label


def _average_precision_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    if average == "micro" and preds.ndim == target.ndim:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
        num_classes = 1

    precision, recall, _ = _precision_recall_curve_compute(preds, target, num_classes, pos_label)
    if average == "weighted":
        if preds.ndim == target.ndim and target.ndim > 1:
            weights = target.sum(dim=0).to(torch.float32)
        else:
            weights = _bincount(target, minlength=num_classes).to(torch.float32)
        weights = weights / torch.sum(weights)
    else:
        weights = None
    return _average_precision_compute_with_precision_recall(precision, recall, num_classes, average, weights)


def _average_precision_compute_with_precision_recall(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Union[List[Tensor], Tensor]:
    """Step-function integral of the PR curve, ``-sum(diff(recall) * precision[:-1])``.

    Per-class curves of one length (the binned metrics') are stacked and
    integrated in one reduction over the last axis, which may differ from
    the JAX package's class-by-class sums in the last place; curves of
    different lengths (the exact ones) are integrated one by one.
    """
    if num_classes == 1:
        return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])

    if len({tuple(p.shape) for p in precision}) == 1:
        p = torch.stack(list(precision))
        r = torch.stack(list(recall))
        res_arr = -torch.sum((r[:, 1:] - r[:, :-1]) * p[:, :-1], dim=-1)
    else:
        res_arr = torch.stack([-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)])

    if average in ("macro", "weighted"):
        nan_mask = torch.isnan(res_arr)
        if bool(nan_mask.any()):
            warnings.warn(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
                UserWarning,
            )
        if average == "macro":
            return torch.where(nan_mask, 0.0, res_arr).sum() / torch.clamp((~nan_mask).sum(), min=1)
        weights = torch.ones_like(res_arr) if weights is None else weights
        return torch.where(nan_mask, 0.0, res_arr * weights).sum()
    if average is None or average == "none":
        return list(res_arr.unbind(0))
    allowed_average = ("micro", "macro", "weighted", None)
    raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    """Average precision score.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision(pred, target, pos_label=1)
        tensor(1.)
    """
    preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label, average)
    return _average_precision_compute(preds, target, num_classes, pos_label, average, sample_weights)
