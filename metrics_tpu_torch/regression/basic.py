"""The sum-state regression metrics (counterpart of
``metrics_tpu/regression/basic.py``): MSE, MAE, MSLE, MAPE, SMAPE and
WMAPE. Each keeps two ``sum`` states in the JAX package's dtypes: a
float32 sum and an int32 count (WMAPE two float32 sums)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.log_mse import (
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)
from metrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from metrics_tpu_torch.functional.regression.mape import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from metrics_tpu_torch.functional.regression.symmetric_mape import (
    _symmetric_mean_absolute_percentage_error_compute,
    _symmetric_mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.functional.regression.wmape import (
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


def _count() -> Tensor:
    return torch.tensor(0, dtype=torch.int32)


class MeanSquaredError(Metric):
    """MSE, or RMSE with ``squared=False``.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = MeanSquaredError(device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.375
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        self.num_outputs = num_outputs
        self.add_state("sum_squared_error", default=torch.zeros(() if num_outputs == 1 else (num_outputs,)), dist_reduce_fx="sum")
        self.add_state("total", default=_count(), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error += sum_squared_error
        self.total += n_obs

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)


class MeanAbsoluteError(Metric):
    """MAE.

    Example:
        >>> import torch
        >>> metric = MeanAbsoluteError(device="cpu")
        >>> round(float(metric(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.5
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=_count(), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error += sum_abs_error
        self.total += n_obs

    def compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)


class MeanSquaredLogError(Metric):
    """MSLE.

    Example:
        >>> import torch
        >>> metric = MeanSquaredLogError(device="cpu")
        >>> round(float(metric(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.128
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=_count(), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error += sum_squared_log_error
        self.total += n_obs

    def compute(self) -> Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)


class MeanAbsolutePercentageError(Metric):
    """MAPE.

    Example:
        >>> import torch
        >>> metric = MeanAbsolutePercentageError(device="cpu")
        >>> round(float(metric(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.3274
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=_count(), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error += sum_abs_per_error
        self.total += num_obs

    def compute(self) -> Tensor:
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)


class SymmetricMeanAbsolutePercentageError(Metric):
    """SMAPE.

    Example:
        >>> import torch
        >>> metric = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> round(float(metric(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.5788
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=_count(), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error += sum_abs_per_error
        self.total += num_obs

    def compute(self) -> Tensor:
        return _symmetric_mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)


class WeightedMeanAbsolutePercentageError(Metric):
    """WMAPE.

    Example:
        >>> import torch
        >>> metric = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> round(float(metric(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.16
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_scale", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error += sum_abs_error
        self.sum_scale += sum_scale

    def compute(self) -> Tensor:
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)
