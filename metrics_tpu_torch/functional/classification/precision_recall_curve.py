"""Precision-recall curves (counterpart of
``metrics_tpu/functional/classification/precision_recall_curve.py``).

A curve has one point per distinct score, so its length depends on the
data: these functions run eagerly on concrete tensors. The masked forms
give fixed-shape results over a ``CatBuffer`` ring.

Counts without sample weights are cumulated in int64 and rounded to
float32 once; the JAX package cumulates in float32, which is the same value
below 2^24 rows.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.masked_common import masked_curve_prologue
from metrics_tpu_torch.ops.bucketed_rank import descending_order, flush_denormals, partition_order
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Cumulative false and true positives at each distinct threshold, in
    descending threshold order, and the thresholds."""
    if sample_weights is not None and not isinstance(sample_weights, Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc = descending_order(preds).long()
    preds = preds[desc]
    target = target[desc]

    # indices of the distinct values (and the end of the curve); denormals
    # are zero in XLA's subtraction, so they are here
    distinct = torch.nonzero(flush_denormals(flush_denormals(preds[1:]) - flush_denormals(preds[:-1]))).reshape(-1)
    threshold_idxs = torch.cat([distinct, torch.tensor([target.shape[0] - 1], device=preds.device)])
    target = (target == pos_label).to(torch.int32)
    if sample_weights is not None:
        weight = sample_weights[desc]
        tps = torch.cumsum(target * weight, 0)[threshold_idxs]
        fps = torch.cumsum((1 - target) * weight, 0)[threshold_idxs]
    else:
        tps = torch.cumsum(target, 0)[threshold_idxs].to(torch.float32)
        fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    """Flatten the inputs into the binary or per-class layout."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.ndim == target.ndim:
        if pos_label is None:
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            preds = preds.movedim(0, 1).reshape(num_classes, -1).T
            target = target.movedim(0, 1).reshape(num_classes, -1).T
        else:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None:
            rank_zero_warn(
                "Argument `pos_label` should be `None` when running"
                f" multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        preds = preds.movedim(0, 1).reshape(num_classes, -1).T
        target = target.reshape(-1)
    else:
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")
    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    fps, tps, thresholds = _binary_clf_curve(preds=preds, target=target, sample_weights=sample_weights, pos_label=pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # stop when full recall is attained; reverse so recall decreases
    last = int(torch.nonzero(tps == tps[-1])[0, 0]) + 1
    precision = torch.cat([precision[:last].flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall[:last].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresholds[:last].flip(0)


def _binary_precision_recall_curve_masked(preds: Tensor, target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The exact binary PR curve over the masked rows, in fixed shapes.

    The eager path's conventions: points at the distinct valid thresholds,
    cut at the first full recall, ordered by decreasing recall, with the
    terminal ``(precision=1, recall=0)``. ``precision`` and ``recall`` are
    ``(cap + 1,)`` (the tail repeats the terminal point, of zero width in
    any step integral); ``thresholds`` is ``(cap,)``, padded with its last
    (largest) threshold.
    """
    cap = preds.shape[0]
    parts = masked_curve_prologue(preds, target, mask)
    s, tps, kv, boundary, n_pos = parts.s, parts.tps, parts.kv, parts.boundary, parts.n_pos
    dev = s.device

    comp = partition_order(boundary).long()
    b_tps, b_kv, b_thr = tps[comp], kv[comp], s[comp]
    n_b = boundary.sum()
    i = torch.arange(cap, device=dev)

    # keep the boundaries up to the first one at full recall: those whose
    # preceding boundary had not reached n_pos
    prev_tps = torch.cat([torch.zeros(1, device=dev), b_tps[:-1]])
    kept = (i < n_b) & (prev_tps < torch.clamp(n_pos, min=1.0))
    m = kept.sum()

    b_prec = b_tps / torch.clamp(b_kv, min=1.0)
    b_rec = b_tps / torch.clamp(n_pos, min=1.0)

    # the kept prefix reversed (recall decreasing), then the (1, 0) terminal
    rev = torch.clamp(m - 1 - i, 0, cap - 1)
    precision = torch.where(i < m, b_prec[rev], 1.0)
    recall = torch.where(i < m, b_rec[rev], 0.0)
    thresholds = torch.where(i < m, b_thr[rev], b_thr[0])
    precision = torch.cat([precision, torch.ones(1, device=dev)])
    recall = torch.cat([recall, torch.zeros(1, device=dev)])
    return precision, recall, thresholds


def _multiclass_precision_recall_curve_masked(
    preds: Tensor, target: Tensor, mask: Tensor, num_classes: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """One-vs-rest masked PR curves, stacked ``(C, ...)``."""
    curves = [
        _binary_precision_recall_curve_masked(preds[:, c], (target == c).to(torch.int32), mask)
        for c in range(num_classes)
    ]
    return tuple(torch.stack(part) for part in zip(*curves))


def _precision_recall_curve_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    """One-vs-rest curves, one per class."""
    precision, recall, thresholds = [], [], []
    for cls in range(num_classes):
        prc_args = dict(preds=preds[:, cls], target=target, num_classes=1, pos_label=cls, sample_weights=sample_weights)
        if target.ndim > 1:
            prc_args.update(dict(target=target[:, cls], pos_label=1))
        res = precision_recall_curve(**prc_args)
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])
    return precision, recall, thresholds


def _precision_recall_curve_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if num_classes == 1:
        if pos_label is None:
            pos_label = 1
        return _precision_recall_curve_compute_single_class(preds, target, pos_label, sample_weights)
    return _precision_recall_curve_compute_multi_class(preds, target, num_classes, sample_weights)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Precision-recall pairs at every distinct threshold.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = precision_recall_curve(pred, target, pos_label=1)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([1, 2, 3])
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
