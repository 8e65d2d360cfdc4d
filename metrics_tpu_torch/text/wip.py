"""``WordInfoPreserved`` (counterpart of ``metrics_tpu/text/wip.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.wip import _wip_compute, _wip_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class WordInfoPreserved(Metric):
    """Word information preserved over accumulated transcript pairs (higher is
    better, as in the JAX package).

    Example:
        >>> metric = WordInfoPreserved(device="cpu")
        >>> metric.update(["the cat sat"], ["the cat sat down"])
        >>> round(float(metric.compute()), 4)
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    jittable_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = _wip_update(preds, target, self.device)
        self.errors += errors
        self.target_total += target_total
        self.preds_total += preds_total

    def compute(self) -> Tensor:
        return _wip_compute(self.errors, self.target_total, self.preds_total)
