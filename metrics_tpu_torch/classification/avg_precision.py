"""``AveragePrecision`` (counterpart of
``metrics_tpu/classification/avg_precision.py``)."""
from typing import Any, List, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
    _binary_average_precision_masked,
    _multiclass_average_precision_masked,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.enums import DataType
from metrics_tpu_torch.utilities.ringbuffer import init_score_ring_states, reject_valid_kwarg, score_ring_update

Tensor = torch.Tensor


class AveragePrecision(Metric):
    """Average precision over the accumulated scores, in the two modes of
    :class:`~metrics_tpu_torch.AUROC`: ``cat`` list states with the PR
    curve's step integral, or ``capacity=N`` rings with the masked
    tie-grouped AP.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AveragePrecision
        >>> metric = AveragePrecision(device="cpu")
        >>> round(float(metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 0]))), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        allowed_average = ("micro", "macro", "weighted", "none", None)
        if average not in allowed_average:
            raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")
        self.average = average
        self.capacity = capacity
        if capacity is not None:
            if average == "micro":
                raise ValueError("`average='micro'` is not supported together with `capacity` mode")
            self.mode = init_score_ring_states(self, capacity, num_classes, pos_label)
        else:
            self.add_state("preds", default=[], dist_reduce_fx="cat", template=torch.zeros((0,), dtype=torch.float32))
            self.add_state("target", default=[], dist_reduce_fx="cat", template=torch.zeros((0,), dtype=torch.int32))

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        if self.capacity is not None:
            score_ring_update(self, preds, target, valid, "AveragePrecision")
            return
        reject_valid_kwarg(valid)
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label, self.average
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tensor, List[Tensor]]:
        if self.capacity is not None:
            if self.mode == DataType.MULTICLASS:
                return _multiclass_average_precision_masked(
                    self.preds.data, self.target.data, self.preds.mask, self.num_classes, self.average
                )
            return _binary_average_precision_masked(self.preds.data, self.target.data, self.preds.mask)
        return _average_precision_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.num_classes, self.pos_label, self.average
        )
