"""Weighted mean absolute percentage error (counterpart of
``metrics_tpu/functional/regression/wmape.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    sum_abs_error = torch.sum(torch.abs((preds - target).reshape(-1)))
    sum_scale = torch.sum(torch.abs(target.reshape(-1)))
    return sum_abs_error, sum_scale


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = 1.17e-06
) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """``sum |preds - target| / max(sum |target|, 1.17e-06)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([1., 10, 1e6])
        >>> preds = torch.tensor([0.9, 15, 1.2e6])
        >>> print(f"{weighted_mean_absolute_percentage_error(preds, target):.4f}")
        0.2000
    """
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
