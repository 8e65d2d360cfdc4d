"""``KLDivergence`` (counterpart of ``metrics_tpu/classification/kl_divergence.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append, reject_valid_kwarg

Tensor = torch.Tensor


class KLDivergence(Metric):
    """KL(P || Q), averaged or summed over rows as a float32 scalar sum, or
    per row (``reduction="none"``) in a ``cat`` list or, with
    ``capacity=N``, a ``CatBuffer`` ring whose unfilled slots compute as
    NaN. An update takes a ``valid`` row mask in the sum and ring modes.

    Example:
        >>> import torch
        >>> metric = KLDivergence(device="cpu")
        >>> p = torch.tensor([[0.5, 0.5]])
        >>> q = torch.tensor([[0.25, 0.75]])
        >>> round(float(metric(p, q)), 4)
        0.1438
        >>> ring = KLDivergence(reduction='none', capacity=4, device="cpu")
        >>> ring.update(p, q)
        >>> [round(float(v), 4) for v in ring.compute()[:1]]
        [0.1438]
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        log_prob: bool = False,
        reduction: Optional[str] = "mean",
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.log_prob = log_prob
        self.reduction = reduction
        self.capacity = capacity

        if self.reduction in ("mean", "sum"):
            self.add_state("measures", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        elif capacity is not None:
            self.add_state("measures", default=CatBuffer.zeros(capacity, (), torch.float32), dist_reduce_fx="cat")
        else:
            self.add_state("measures", default=[], dist_reduce_fx="cat", template=torch.zeros((0,), dtype=torch.float32))
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor, valid: Optional[Tensor] = None) -> None:
        """``valid`` (bool ``(N,)``) masks rows in the ring and in the
        mean/sum folds; ``total`` counts the valid rows."""
        measures, total = _kld_update(p, q, self.log_prob)
        if valid is not None:
            valid = torch.as_tensor(valid, device=measures.device).to(torch.bool)
        if self.reduction is None or self.reduction == "none":
            if self.capacity is not None:
                if valid is not None:
                    total = valid.sum(dtype=torch.int32)
                self.measures = cat_append(self.measures, measures, valid)
            else:
                reject_valid_kwarg(valid)
                self.measures.append(measures)
        else:
            if valid is not None:
                # a select, not a product: an invalid row may hold NaN
                measures = torch.where(valid, measures, 0.0)
                total = valid.sum(dtype=torch.int32)
            self.measures = measures.sum() + self.measures
        self.total = total + self.total

    def compute(self) -> Tensor:
        if self.reduction in ("none", None) and self.capacity is not None:
            return torch.where(self.measures.mask, self.measures.data, float("nan"))
        measures = dim_zero_cat(self.measures) if self.reduction in ("none", None) else self.measures
        return _kld_compute(measures, self.total, self.reduction)
