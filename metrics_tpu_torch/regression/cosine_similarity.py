"""``CosineSimilarity`` (counterpart of
``metrics_tpu/regression/cosine_similarity.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append, reject_valid_kwarg

Tensor = torch.Tensor


class CosineSimilarity(Metric):
    """Cosine similarity of the rows of ``preds`` and ``target``.

    Two modes, as in the JAX package:

    - default: the rows accumulate in ``cat`` list states;
    - ``capacity=N``: with ``reduction`` ``"sum"`` or ``"mean"`` the
      similarities fold into two float32 ``sum`` states (exact for any
      number of rows); with ``"none"``/``None`` they go into a
      :class:`CatBuffer` ring of ``N`` rows, which drops and counts the rows
      past it, and ``compute`` returns the whole ring with NaN at unfilled
      slots. ``valid`` (bool ``(N,)``) masks rows in this mode only.

    Example:
        >>> import torch
        >>> metric = CosineSimilarity(reduction="mean", device="cpu")
        >>> round(float(metric(torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([[2.0, 4.0, 6.0]]))), 4)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "sum", capacity: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.capacity = capacity
        if capacity is not None:
            if reduction in ("sum", "mean"):
                self.add_state("sum_sim", default=torch.tensor(0.0), dist_reduce_fx="sum")
                self.add_state("n_total", default=torch.tensor(0.0), dist_reduce_fx="sum")
            else:
                self.add_state("sims", default=CatBuffer.zeros(capacity, (), torch.float32), dist_reduce_fx="cat")
        else:
            # rows of a data-dependent width: no template
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        preds, target = _cosine_similarity_update(preds, target)
        if self.capacity is not None:
            sims = _cosine_similarity_compute(preds, target, "none")
            if valid is not None:
                # select, not multiply: a zero row's similarity is NaN
                sims = torch.where(torch.as_tensor(valid, device=sims.device).to(torch.bool), sims, 0.0)
            if self.reduction in ("sum", "mean"):
                self.sum_sim += sims.sum()
                if valid is None:
                    self.n_total += float(sims.shape[0])
                else:
                    self.n_total += torch.as_tensor(valid, device=sims.device).to(torch.float32).sum()
            else:
                self.sims = cat_append(self.sims, sims, valid)
            return
        reject_valid_kwarg(valid)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        if self.capacity is not None:
            if self.reduction == "sum":
                return self.sum_sim
            if self.reduction == "mean":
                return self.sum_sim / self.n_total
            return torch.where(self.sims.mask, self.sims.data, float("nan"))
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _cosine_similarity_compute(preds, target, self.reduction)
