"""Mean squared log error (counterpart of
``metrics_tpu/functional/regression/log_mse.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    sum_squared_log_error = torch.sum((torch.log1p(preds) - torch.log1p(target)) ** 2)
    return sum_squared_log_error, target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, n_obs: Tensor) -> Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean of ``(log1p(preds) - log1p(target))**2``.

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1, 2, 3])
        >>> y = torch.tensor([0., 1, 2, 2])
        >>> print(f"{mean_squared_log_error(x, y):.4f}")
        0.0207
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
