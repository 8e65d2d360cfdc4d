"""Mean absolute error (counterpart of
``metrics_tpu/functional/regression/mae.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.compute import _to_float

Tensor = torch.Tensor


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    preds = _to_float(preds)
    target = _to_float(target)
    _check_same_shape(preds, target)
    sum_abs_error = torch.sum(torch.abs(preds - target))
    return sum_abs_error, target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, n_obs: Tensor) -> Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean of ``|preds - target|``.

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1, 2, 3])
        >>> y = torch.tensor([0., 1, 2, 1])
        >>> mean_absolute_error(x, y)
        tensor(0.5000)
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
