"""``WordInfoLost`` (counterpart of ``metrics_tpu/text/wil.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.wil import _wil_compute, _wil_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class WordInfoLost(Metric):
    """Word information lost over accumulated transcript pairs.

    Example:
        >>> metric = WordInfoLost(device="cpu")
        >>> metric.update(["the cat sat"], ["the cat sat down"])
        >>> round(float(metric.compute()), 4)
        0.25
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    jittable_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = _wil_update(preds, target, self.device)
        self.errors += errors
        self.target_total += target_total
        self.preds_total += preds_total

    def compute(self) -> Tensor:
        return _wil_compute(self.errors, self.target_total, self.preds_total)
