"""True/false positive/negative counting, the classification backbone
(counterpart of ``metrics_tpu/functional/classification/stat_scores.py``).

Ignored classes carry the ``-1`` sentinel and are masked with ``where``, as
in the JAX package. Counters are int32, the JAX package's dtype.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.checks import (
    _check_shape_and_type_consistency,
    _input_format_classification,
    _input_squeeze,
)
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType, MDMCAverageMethod

Tensor = torch.Tensor


def _del_column(data: Tensor, idx: int) -> Tensor:
    """Drop column ``idx``."""
    return torch.cat([data[:, :idx], data[:, idx + 1 :]], dim=1)


def _drop_negative_ignored_indices(
    preds: Tensor, target: Tensor, ignore_index: int, mode: DataType
) -> Tuple[Tensor, Tensor]:
    """Remove samples whose target equals a negative ``ignore_index``."""
    if mode == DataType.MULTIDIM_MULTICLASS and preds.is_floating_point():
        num_classes = preds.shape[1]
        preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
        target = target.reshape(-1)
    if mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        keep = target != ignore_index
        preds = preds[keep]
        target = target[keep]
    return preds, target


def _stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Count tp/fp/tn/fn over canonical binary ``(N, C)`` / ``(N, C, X)`` inputs.

    ``valid`` is an optional bool ``(N,)`` row mask: a False row adds to no
    counter. Only the row-reducing modes (micro, macro) take it: a
    per-sample output keeps one row per input row."""
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2
    else:  # samples
        dim = 1

    true_pred = target == preds
    pos_pred = preds == 1

    if valid is not None:
        if reduce == "samples":
            raise ValueError("`valid` row masks are not supported with reduce='samples'")
        v = torch.as_tensor(valid, device=preds.device).to(torch.bool).reshape((preds.shape[0],) + (1,) * (preds.ndim - 1))
        true_pred, pos_pred, neg_pred = true_pred & v, pos_pred & v, ~pos_pred & v
    else:
        neg_pred = ~pos_pred

    tp = torch.sum(true_pred & pos_pred, dim=dim)
    fp = torch.sum(~true_pred & pos_pred, dim=dim)
    tn = torch.sum(true_pred & neg_pred, dim=dim)
    fn = torch.sum(~true_pred & neg_pred, dim=dim)
    return tp.to(torch.int32), fp.to(torch.int32), tn.to(torch.int32), fn.to(torch.int32)


def _stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    mode: Optional[DataType] = None,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Canonicalise inputs and count tp/fp/tn/fn; a row that ``valid``
    masks adds to no counter (the canonicalisation keeps rows in order)."""
    if valid is not None and ignore_index is not None and ignore_index < 0:
        # the negative-ignore path drops rows by boolean indexing, which
        # would misalign the mask
        raise ValueError("`valid` row masks are not supported with a negative `ignore_index`")
    if valid is not None and (reduce == "samples" or mdmc_reduce == "samplewise"):
        raise ValueError("`valid` row masks are not supported with per-sample reductions")
    _negative_index_dropped = False
    if ignore_index is not None and ignore_index < 0:
        if mode is None:
            mode, _ = _check_shape_and_type_consistency(*_input_squeeze(torch.as_tensor(preds), torch.as_tensor(target)))
        preds, target = _drop_negative_ignored_indices(preds, target, ignore_index, mode)
        _negative_index_dropped = True

    preds, target, _ = _input_format_classification(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
    )

    if ignore_index is not None and ignore_index >= preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            if valid is not None:
                # (N, C, X) -> (N*X, C) row-major: each row's bit covers its X samples
                valid = torch.repeat_interleave(torch.as_tensor(valid, device=preds.device).to(torch.bool), preds.shape[2])
            preds = torch.movedim(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.movedim(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro" and not _negative_index_dropped:
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce, valid=valid)

    if ignore_index is not None and reduce == "macro" and not _negative_index_dropped:
        # mark the ignored class with the -1 sentinel
        idx = torch.arange(tp.shape[-1], device=tp.device) == ignore_index
        minus_one = torch.tensor(-1, dtype=tp.dtype, device=tp.device)
        tp = torch.where(idx, minus_one, tp)
        fp = torch.where(idx, minus_one, fp)
        tn = torch.where(idx, minus_one, tn)
        fn = torch.where(idx, minus_one, fn)

    return tp, fp, tn, fn


def _stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """Stack [tp, fp, tn, fn, support] along a trailing axis."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, torch.tensor(-1, dtype=outputs.dtype, device=outputs.device), outputs)


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: float = 0.0,
) -> Tensor:
    """Score reduction ``weights * num / denom``: ``denominator < 0`` marks an
    ignored class (weight 0, or NaN when ``average=None``); ``denominator == 0``
    yields ``zero_division``."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)

    numerator = torch.where(zero_div_mask, zero_division, numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), zero_division, scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0).to(torch.bool)

    if average in (AverageMethod.NONE, None):
        scores = torch.where(ignore_mask, float("nan"), scores)
    else:
        scores = torch.sum(scores)

    return scores


def stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Number of tp/fp/tn/fn/support."""
    if reduce not in ["micro", "macro", "samples"]:
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in [None, "samplewise", "global"]:
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        top_k=top_k,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
