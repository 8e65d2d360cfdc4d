"""Explained variance (counterpart of
``metrics_tpu/functional/regression/explained_variance.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    n_obs = preds.shape[0]
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    n_obs: Tensor,
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    """1 - Var(target - preds) / Var(target) per output: 1 where both
    variances are 0, 0 where only the target's is."""
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - (diff_avg * diff_avg)

    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - (target_avg * target_avg)

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    output_scores = torch.ones_like(diff_avg)
    safe_denom = torch.where(nonzero_denominator, denominator, 1.0)
    output_scores = torch.where(valid_score, 1.0 - (numerator / safe_denom), output_scores)
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, output_scores)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(f"Invalid input to multioutput: {multioutput}")


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> print(f"{explained_variance(preds, target):.4f}")
        0.9572
    """
    n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target, multioutput)
