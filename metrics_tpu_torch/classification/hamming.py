"""``HammingDistance`` (counterpart of ``metrics_tpu/classification/hamming.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.hamming import _hamming_distance_compute, _hamming_distance_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class HammingDistance(Metric):
    """The share of wrongly predicted labels, from int32 sums.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.05, 0.15], [0.1, 0.15, 0.7, 0.05],
        ...                       [0.3, 0.4, 0.2, 0.1], [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> metric = HammingDistance(device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.375
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.threshold = threshold
        self.add_state("correct", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct += correct
        self.total += total

    def compute(self) -> Tensor:
        return _hamming_distance_compute(self.correct, self.total)
