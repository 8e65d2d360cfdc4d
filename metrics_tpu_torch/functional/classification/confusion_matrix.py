"""The confusion matrix (counterpart of
``metrics_tpu/functional/classification/confusion_matrix.py``).

The counts of ``target * C + pred`` come from
:func:`~metrics_tpu_torch.utilities.data._bincount`: the histogram kernel
(K2) on the card, which reads nothing back to the host, and a plain
``bincount`` on the CPU. Counts are int32, the JAX package's dtype.
"""
from typing import Optional

import torch

from metrics_tpu_torch.utilities.checks import (
    _check_shape_and_type_consistency,
    _input_format_classification,
    _input_squeeze,
)
from metrics_tpu_torch.utilities.data import _bincount
from metrics_tpu_torch.utilities.enums import DataType
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

_ALLOWED_NORMALIZE = ("true", "pred", "all", "none", None)


def _confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5, multilabel: bool = False
) -> Tensor:
    """The batch's un-normalised matrix: ``(C, C)`` int32 counts, or
    ``(C, 2, 2)`` per-class binary matrices when ``multilabel=True``.

    ``num_classes`` reaches the canonicalisation only for (multi-dimensional)
    multi-class inputs, as in the JAX package: a label at or above it becomes
    an all-zero one-hot row, whose argmax counts it as class 0 (the fault
    channel counts such labels)."""
    p_sq, t_sq = _input_squeeze(torch.as_tensor(preds), torch.as_tensor(target))
    static_case, _ = _check_shape_and_type_consistency(p_sq, t_sq)
    nc_arg = num_classes if static_case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) else None
    preds, target, mode = _input_format_classification(p_sq, t_sq, threshold, num_classes=nc_arg)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = torch.argmax(preds, dim=1)
        target = torch.argmax(target, dim=1)
    if multilabel:
        offsets = 4 * torch.arange(num_classes, dtype=torch.int32, device=preds.device)
        unique_mapping = ((2 * target + preds) + offsets).reshape(-1)
        minlength = 4 * num_classes
    else:
        unique_mapping = (target.reshape(-1) * num_classes + preds.reshape(-1)).to(torch.int32)
        minlength = num_classes**2

    bins = _bincount(unique_mapping, minlength=minlength)
    if multilabel:
        return bins.reshape(num_classes, 2, 2)
    return bins.reshape(num_classes, num_classes)


def _confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalise over true labels (rows), predictions (columns) or all
    cells, in float32; a NaN from an empty row or column becomes 0, with a
    warning (which reads the NaN count back)."""
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument average needs to one of the following: {_ALLOWED_NORMALIZE}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=0, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum()
        nan_elements = int(torch.isnan(confmat).sum())
        if nan_elements:
            rank_zero_warn(f"{nan_elements} nan values found in confusion matrix have been replaced with zeros.")
        confmat = torch.nan_to_num(confmat, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
    return confmat


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> Tensor:
    """The confusion matrix: rows are true labels, columns predictions.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confusion_matrix(preds, target, num_classes=2)
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)
