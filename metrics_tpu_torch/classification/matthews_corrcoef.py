"""``MatthewsCorrCoef`` (counterpart of
``metrics_tpu/classification/matthews_corrcoef.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MatthewsCorrCoef(Metric):
    """The Matthews correlation coefficient over an accumulated int32
    confusion matrix.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.05, 0.15], [0.1, 0.15, 0.7, 0.05],
        ...                       [0.3, 0.4, 0.2, 0.1], [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> metric = MatthewsCorrCoef(num_classes=4, device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_classes: int, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.threshold = threshold
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.confmat += _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> Tensor:
        return _matthews_corrcoef_compute(self.confmat)
