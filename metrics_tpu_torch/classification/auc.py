"""``AUC`` (counterpart of ``metrics_tpu/classification/auc.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute_masked, _auc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.compute import _auc_compute
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append, reject_valid_kwarg

Tensor = torch.Tensor


class AUC(Metric):
    """Area under any ``(x, y)`` curve by the trapezoid rule: ``cat`` list
    states, or ``capacity=N`` rings with the masked trapezoid (points past
    capacity are dropped and counted).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUC
        >>> metric = AUC(reorder=True, device="cpu")
        >>> round(float(metric(torch.tensor([0.0, 0.5, 1.0]), torch.tensor([0.0, 0.5, 1.0]))), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better: Optional[bool] = None
    full_state_update = False

    def __init__(self, reorder: bool = False, capacity: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reorder = reorder
        self.capacity = capacity
        if capacity is not None:
            self.add_state("x", default=CatBuffer.zeros(capacity, (), torch.float32), dist_reduce_fx="cat")
            self.add_state("y", default=CatBuffer.zeros(capacity, (), torch.float32), dist_reduce_fx="cat")
        else:
            tpl = torch.zeros((0,), dtype=torch.float32)
            self.add_state("x", default=[], dist_reduce_fx="cat", template=tpl)
            self.add_state("y", default=[], dist_reduce_fx="cat", template=tpl)

    def update(self, x: Tensor, y: Tensor, valid: Optional[Tensor] = None) -> None:
        """``valid`` (bool ``(N,)``) is taken in capacity mode only."""
        x, y = _auc_update(x, y)
        if self.capacity is not None:
            self.x = cat_append(self.x, x, valid)
            self.y = cat_append(self.y, y, valid)
            return
        reject_valid_kwarg(valid)
        self.x.append(x)
        self.y.append(y)

    def compute(self) -> Tensor:
        if self.capacity is not None:
            return _auc_compute_masked(self.x.data, self.y.data, self.x.mask, reorder=self.reorder)
        return _auc_compute(dim_zero_cat(self.x), dim_zero_cat(self.y), reorder=self.reorder)
