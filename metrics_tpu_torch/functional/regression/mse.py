"""Mean squared error (counterpart of
``metrics_tpu/functional/regression/mse.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=0)
    return sum_squared_error, target.shape[0]


def _mean_squared_error_compute(sum_squared_error: Tensor, n_obs: Tensor, squared: bool = True) -> Tensor:
    mse = sum_squared_error / n_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """Mean squared error, or its root with ``squared=False``.

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1, 2, 3])
        >>> y = torch.tensor([0., 1, 2, 2])
        >>> mean_squared_error(x, y)
        tensor(0.2500)
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)
