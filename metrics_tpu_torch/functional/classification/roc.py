"""Receiver operating characteristic curves (counterpart of
``metrics_tpu/functional/classification/roc.py``).

Eager, with data-dependent lengths, like the PR curve; the masked forms
give fixed-shape results over a ``CatBuffer`` ring.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.masked_common import masked_curve_prologue
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_clf_curve,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.ops.bucketed_rank import partition_order
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _roc_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    """The PR curve's canonicalisation."""
    return _precision_recall_curve_update(preds, target, num_classes, pos_label)


def _roc_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    fps, tps, thresholds = _binary_clf_curve(preds=preds, target=target, sample_weights=sample_weights, pos_label=pos_label)
    # an extra threshold so the curve starts at (0, 0)
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thresholds = torch.cat([thresholds[:1] + 1, thresholds])

    if fps[-1] <= 0:
        rank_zero_warn(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
        )
        fpr = torch.zeros(thresholds.shape, dtype=torch.float32, device=thresholds.device)
    else:
        fpr = fps / fps[-1]

    if tps[-1] <= 0:
        rank_zero_warn(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
        )
        tpr = torch.zeros(thresholds.shape, dtype=torch.float32, device=thresholds.device)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def _binary_roc_masked(preds: Tensor, target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The exact binary ROC over the masked rows, as ``(cap + 1,)`` tensors.

    Point 0 is the eager path's leading ``(0, 0, max_threshold + 1)``; the
    curve's points (one per distinct valid threshold, descending) follow,
    and the tail repeats the terminal point ``(1, 1, min_threshold)``, so a
    trapezoid integral over the padded curve equals the exact one. No
    negatives (positives) zero out fpr (tpr), as the eager path does.
    """
    cap = preds.shape[0]
    parts = masked_curve_prologue(preds, target, mask)
    s, tps, boundary = parts.s, parts.tps, parts.boundary
    fps = parts.kv - tps
    n_pos = parts.n_pos
    n_neg = parts.n_valid - n_pos
    dev = s.device

    # the boundary rows to the front, in descending order
    comp = partition_order(boundary).long()
    b_tps, b_fps, b_thr = tps[comp], fps[comp], s[comp]
    n_b = boundary.sum()
    i = torch.arange(cap, device=dev)

    last_thr = b_thr[torch.clamp(n_b - 1, min=0)]
    tpr_body = torch.where(i < n_b, b_tps, n_pos) / torch.clamp(n_pos, min=1.0)
    fpr_body = torch.where(i < n_b, b_fps, n_neg) / torch.clamp(n_neg, min=1.0)
    thr_body = torch.where(i < n_b, b_thr, last_thr)

    zero = torch.zeros(1, device=dev)
    fpr = torch.cat([zero, fpr_body])
    tpr = torch.cat([zero, tpr_body])
    thresholds = torch.cat([b_thr[:1] + 1, thr_body])
    return fpr, tpr, thresholds


def _multiclass_roc_masked(preds: Tensor, target: Tensor, mask: Tensor, num_classes: int) -> Tuple[Tensor, Tensor, Tensor]:
    """One-vs-rest masked ROC curves, stacked ``(C, cap + 1)``."""
    curves = [_binary_roc_masked(preds[:, c], (target == c).to(torch.int32), mask) for c in range(num_classes)]
    return tuple(torch.stack(part) for part in zip(*curves))


def _roc_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    fpr, tpr, thresholds = [], [], []
    for cls in range(num_classes):
        if preds.shape == target.shape:
            target_cls, pos_label = target[:, cls], 1
        else:
            target_cls, pos_label = target, cls
        res = roc(preds=preds[:, cls], target=target_cls, num_classes=1, pos_label=pos_label, sample_weights=sample_weights)
        fpr.append(res[0])
        tpr.append(res[1])
        thresholds.append(res[2])
    return fpr, tpr, thresholds


def _roc_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if num_classes == 1 and preds.ndim == 1:
        if pos_label is None:
            pos_label = 1
        return _roc_compute_single_class(preds, target, pos_label, sample_weights)
    return _roc_compute_multi_class(preds, target, num_classes, sample_weights)


def roc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Receiver operating characteristic.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> fpr, tpr, thresholds = roc(pred, target, pos_label=1)
        >>> fpr
        tensor([0., 0., 0., 0., 1.])
        >>> tpr
        tensor([0.0000, 0.3333, 0.6667, 1.0000, 1.0000])
    """
    preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    return _roc_compute(preds, target, num_classes, pos_label, sample_weights)
