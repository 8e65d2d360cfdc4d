"""``HingeLoss`` (counterpart of ``metrics_tpu/classification/hinge.py``)."""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.hinge import (
    MulticlassMode,
    _check_multiclass_mode,
    _hinge_compute,
    _hinge_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class HingeLoss(Metric):
    """The mean hinge loss: a float32 sum (``(C,)`` for one-vs-all) and an
    int32 row count.

    Example:
        >>> import torch
        >>> metric = HingeLoss(device="cpu")
        >>> round(float(metric(torch.tensor([0.5, -0.5]), torch.tensor([1, 0]))), 4)
        0.5
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("measure", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        _check_multiclass_mode(multiclass_mode)
        self.squared = squared
        self.multiclass_mode = multiclass_mode

    def update(self, preds: Tensor, target: Tensor) -> None:
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)
        self.measure = measure + self.measure
        self.total = total + self.total

    def compute(self) -> Tensor:
        return _hinge_compute(self.measure, self.total)
