"""``TweedieDevianceScore`` (counterpart of
``metrics_tpu/regression/tweedie_deviance.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class TweedieDevianceScore(Metric):
    """Mean Tweedie deviance, a float32 sum and an int32 count. A deviance
    is a loss: ``higher_is_better`` is False, as in the JAX package.

    Example:
        >>> import torch
        >>> metric = TweedieDevianceScore(device="cpu")
        >>> round(float(metric(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.375
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_observations", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
