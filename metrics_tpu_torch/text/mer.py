"""``MatchErrorRate`` (counterpart of ``metrics_tpu/text/mer.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.mer import _mer_compute, _mer_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MatchErrorRate(Metric):
    """Match error rate over accumulated transcript pairs.

    The update takes strings (host tokenization, then the wavefront on the
    metric's device), so it runs eagerly; the two float32 ``sum`` states
    sync in one collective.

    Example:
        >>> metric = MatchErrorRate(device="cpu")
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
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _mer_update(preds, target, self.device)
        self.errors += errors
        self.total += total

    def compute(self) -> Tensor:
        return _mer_compute(self.errors, self.total)
