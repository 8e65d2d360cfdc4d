"""Symmetric mean absolute percentage error (counterpart of
``metrics_tpu/functional/regression/symmetric_mape.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _symmetric_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = 1.17e-06
) -> Tuple[Tensor, int]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    abs_per_error = 2 * torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    sum_abs_per_error = torch.sum(abs_per_error)
    return sum_abs_per_error, target.numel()


def _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Tensor) -> Tensor:
    return sum_abs_per_error / num_obs


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean of ``2 |preds - target| / max(|target| + |preds|, 1.17e-06)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([1., 10, 1e6])
        >>> preds = torch.tensor([0.9, 15, 1.2e6])
        >>> print(f"{symmetric_mean_absolute_percentage_error(preds, target):.4f}")
        0.2290
    """
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
