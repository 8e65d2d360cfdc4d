"""Spectral Angle Mapper (counterpart of ``metrics_tpu/functional/image/sam.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _sam_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[1] <= 1 or target.shape[1] <= 1:
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]} and target: {target.shape[1]}."
        )
    return preds, target


def _sam_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """SAM.

    Example:
        >>> import torch
        >>> g = torch.Generator().manual_seed(42)
        >>> preds = torch.rand((8, 3, 16, 16), generator=g)
        >>> target = torch.rand((8, 3, 16, 16), generator=g)
        >>> float(spectral_angle_mapper(preds, target)) > 0
        True
    """
    preds, target = _sam_update(preds, target)
    return _sam_compute(preds, target, reduction)
