"""Pearson correlation (counterpart of
``metrics_tpu/functional/regression/pearson.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    n_prior: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The running means, the sums of squared deviations and of
    co-deviations, and the count, after one more batch (Welford's update
    over the batch's mean)."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    preds = preds.squeeze()
    target = target.squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")

    n_obs = preds.numel()
    mx_new = (n_prior * mean_x + preds.mean() * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + target.mean() * n_obs) / (n_prior + n_obs)
    n_prior = n_prior + n_obs
    var_x = var_x + ((preds - mx_new) * (preds - mean_x)).sum()
    var_y = var_y + ((target - my_new) * (target - mean_y)).sum()
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum()
    return mx_new, my_new, var_x, var_y, corr_xy, n_prior


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = (corr_xy / torch.sqrt(var_x * var_y)).squeeze()
    return torch.clamp(corrcoef, -1.0, 1.0)


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient of two 1-d tensors.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> print(f"{pearson_corrcoef(preds, target):.4f}")
        0.9849
    """
    preds = torch.as_tensor(preds)
    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    zero = torch.zeros((), dtype=dtype, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
