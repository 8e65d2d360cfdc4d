"""ERGAS (counterpart of ``metrics_tpu/functional/image/ergas.py``)."""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _ergas_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
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
    return preds, target


def _ergas_compute(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target, dim=2)
    ergas_score = 100 * ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """ERGAS.

    Example:
        >>> import torch
        >>> preds = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4) / 16
        >>> target = preds * 0.75
        >>> print(f"{error_relative_global_dimensionless_synthesis(preds, target):.2f}")
        156.51
    """
    preds, target = _ergas_update(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
