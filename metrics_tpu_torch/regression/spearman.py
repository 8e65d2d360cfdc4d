"""``SpearmanCorrCoef`` (counterpart of ``metrics_tpu/regression/spearman.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.regression.spearman import (
    _spearman_corrcoef_compute,
    _spearman_corrcoef_update,
    _spearman_masked,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append

Tensor = torch.Tensor


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation over the accumulated rows.

    Two modes, as in the JAX package: ``cat`` list states ranked at
    ``compute``, or with ``capacity=N`` two float32 :class:`CatBuffer` rings
    of ``N`` rows (rows past it are dropped and counted), ranked with their
    mask; ``valid`` (bool ``(N,)``) masks rows in that mode only.

    Example:
        >>> import torch
        >>> metric = SpearmanCorrCoef(device="cpu")
        >>> round(float(metric(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, capacity: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.capacity = capacity
        if capacity is not None:
            self.add_state("preds", default=CatBuffer.zeros(capacity, (), torch.float32), dist_reduce_fx="cat")
            self.add_state("target", default=CatBuffer.zeros(capacity, (), torch.float32), dist_reduce_fx="cat")
        else:
            tpl = torch.zeros((0,), dtype=torch.float32)
            self.add_state("preds", default=[], dist_reduce_fx="cat", template=tpl)
            self.add_state("target", default=[], dist_reduce_fx="cat", template=tpl)

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        if self.capacity is not None:
            preds = torch.as_tensor(preds).to(torch.float32)
            target = torch.as_tensor(target).to(torch.float32)
            if preds.shape != target.shape:
                raise ValueError(f"Expected `preds` and `target` of the same shape, got {tuple(preds.shape)} vs {tuple(target.shape)}")
            preds = preds.squeeze()
            target = target.squeeze()
            if preds.ndim > 1:
                raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
            self.preds = cat_append(self.preds, torch.atleast_1d(preds), valid)
            self.target = cat_append(self.target, torch.atleast_1d(target), valid)
            return
        if valid is not None:
            raise ValueError("`valid` masks are only supported in capacity (static-shape) mode")
        preds, target = _spearman_corrcoef_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        if self.capacity is not None:
            return _spearman_masked(self.preds.data, self.target.data, self.preds.mask)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _spearman_corrcoef_compute(preds, target)
