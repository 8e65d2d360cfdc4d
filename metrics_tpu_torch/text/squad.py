"""``SQuAD`` (counterpart of ``metrics_tpu/text/squad.py``)."""
from typing import Any, Dict

import torch

from metrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class SQuAD(Metric):
    """SQuAD exact-match / F1 with three scalar ``sum`` states (float32
    sums, an int32 total).

    Example:
        >>> metric = SQuAD(device="cpu")
        >>> preds = [{"prediction_text": "the cat", "id": "1"}]
        >>> target = [{"answers": {"text": ["the cat"], "answer_start": [0]}, "id": "1"}]
        >>> out = metric(preds, target)
        >>> float(out["exact_match"]), float(out["f1"])
        (100.0, 100.0)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    jittable_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("exact_match", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, target_dict, self.device)
        self.f1_score += f1
        self.exact_match += exact_match
        self.total += total

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
