"""Area under the ROC curve (counterpart of
``metrics_tpu/functional/classification/auroc.py``)."""
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.ops.bucketed_rank import _float32_ascending_key
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.compute import _auc_compute_without_check
from metrics_tpu_torch.utilities.data import _bincount
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType

Tensor = torch.Tensor


def _auroc_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, DataType]:
    """Check the inputs, find their mode, and flatten multi-dim layouts."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.MULTIDIM_MULTICLASS and preds.ndim == target.ndim + 1:
        n_classes = preds.shape[1]
        preds = preds.movedim(0, 1).reshape(n_classes, -1).T
        target = target.reshape(-1)
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = preds.movedim(0, 1).reshape(n_classes, -1).T
        target = target.movedim(0, 1).reshape(n_classes, -1).T
    return preds, target, mode


def _auroc_compute(
    preds: Tensor,
    target: Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    if mode == DataType.BINARY:
        num_classes = 1

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                "Partial AUC computation not available in multilabel/multiclass setting,"
                f" 'max_fpr' must be set to `None`, received `{max_fpr}`."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            fpr, tpr, _ = roc(preds.reshape(-1), target.reshape(-1), 1, pos_label, sample_weights)
        elif num_classes:
            output = [
                roc(preds[:, i], target[:, i], num_classes=1, pos_label=1, sample_weights=sample_weights)
                for i in range(num_classes)
            ]
            fpr = [o[0] for o in output]
            tpr = [o[1] for o in output]
        else:
            raise ValueError("Detected input to be `multilabel` but you did not provide `num_classes` argument")
    else:
        if mode != DataType.BINARY:
            if num_classes is None:
                raise ValueError("Detected input to `multiclass` but you did not provide `num_classes` argument")
            if average == AverageMethod.WEIGHTED and len(torch.unique(target)) < num_classes:
                # classes with no observation are left out (their weight is 0)
                target_bool_mat = torch.nn.functional.one_hot(target.long(), num_classes).to(torch.bool)
                class_observed = target_bool_mat.sum(dim=0) > 0
                for c in range(num_classes):
                    if not bool(class_observed[c]):
                        warnings.warn(f"Class {c} had 0 observations, omitted from AUROC calculation", UserWarning)
                preds = preds[:, class_observed]
                target_bool_mat = target_bool_mat[:, class_observed]
                target = torch.nonzero(target_bool_mat)[:, 1]
                num_classes = int(class_observed.sum())
                if num_classes == 1:
                    raise ValueError("Found 1 non-empty class in `multiclass` AUROC calculation")
        fpr, tpr, _ = roc(preds, target, num_classes, pos_label, sample_weights)

    if max_fpr is None or max_fpr == 1:
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            pass
        elif num_classes != 1:
            auc_scores = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
            if average == AverageMethod.NONE:
                return auc_scores
            if average == AverageMethod.MACRO:
                return torch.mean(auc_scores)
            if average == AverageMethod.WEIGHTED:
                if mode == DataType.MULTILABEL:
                    support = torch.sum(target, dim=0)
                else:
                    support = _bincount(target.reshape(-1), minlength=num_classes)
                return torch.sum(auc_scores * support / support.sum())
            allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        return _auc_compute_without_check(fpr, tpr, 1.0)

    # partial AUC over [0, max_fpr] with the McClish correction
    max_area = torch.tensor(max_fpr, dtype=torch.float32, device=fpr.device)
    stop = int(torch.searchsorted(fpr, max_area.reshape(1), right=True))
    weight = (max_area - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])
    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    """Area under the ROC curve.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc(preds, target, pos_label=1)
        tensor(0.5000)
    """
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)


def _binary_auroc_masked(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """AUROC of the rows where ``mask`` is True, as the tie-averaged rank
    statistic (Mann-Whitney U): the trapezoid ROC area, in fixed shapes with
    one sort and two searches.

    The sort and the searches run over the orderable float32 keys, so they
    compare as the JAX package's do: ``-0.0`` equals ``+0.0``, denormals are
    zero, NaNs are the largest.
    """
    mask = mask.to(torch.bool)
    pos = mask & (target == 1)
    neg = mask & (target != 1)
    n_pos = pos.sum().to(torch.float32)
    n_neg = neg.sum().to(torch.float32)
    preds = preds.to(torch.float32)
    # negatives sorted with the left-out rows pushed to +inf (never counted
    # as less); the <= count is capped at the negatives' total, so a real
    # +inf score does not count the padding as ties
    neg_sorted = torch.sort(_float32_ascending_key(torch.where(neg, preds, float("inf")))).values
    key = _float32_ascending_key(preds)
    less = torch.searchsorted(neg_sorted, key).to(torch.float32)
    leq = torch.minimum(torch.searchsorted(neg_sorted, key, right=True).to(torch.float32), n_neg)
    u = torch.sum(torch.where(pos, less + 0.5 * (leq - less), 0.0))
    return u / (n_pos * n_neg)


def _multiclass_auroc_masked(
    preds: Tensor,
    target: Tensor,
    mask: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
) -> Tensor:
    """One-vs-rest masked AUROC over a ``(cap, C)`` score buffer."""
    mask = mask.to(torch.bool)
    per_class = torch.stack(
        [_binary_auroc_masked(preds[:, c], (target == c).to(torch.int32), mask) for c in range(num_classes)]
    )
    if average in (AverageMethod.NONE, "none", None):
        return per_class
    # a class with no positives or no negatives is NaN (0/0); the averages
    # run over the defined classes only
    counts = torch.stack([(mask & (target == c)).sum() for c in range(num_classes)]).to(torch.float32)
    n_valid = mask.sum().to(torch.float32)
    defined = (counts > 0) & (counts < n_valid)
    safe = torch.where(defined, per_class, 0.0)
    if average == AverageMethod.MACRO:
        return torch.sum(safe) / torch.sum(defined.to(torch.float32))
    if average == AverageMethod.WEIGHTED:
        weights = torch.where(defined, counts, 0.0)
        return torch.sum(safe * weights / torch.sum(weights))
    raise ValueError(f"Average {average!r} is not supported in masked AUROC")
