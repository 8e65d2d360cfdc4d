"""``PrecisionRecallCurve`` (counterpart of
``metrics_tpu/classification/precision_recall_curve.py``)."""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_masked,
    _multiclass_precision_recall_curve_masked,
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.enums import DataType
from metrics_tpu_torch.utilities.ringbuffer import init_score_ring_states, reject_valid_kwarg, score_ring_update

Tensor = torch.Tensor


class PrecisionRecallCurve(Metric):
    """Exact precision-recall pairs at every threshold; ``capacity=N`` keeps
    ``CatBuffer`` rings and returns fixed-shape, terminal-padded curves.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PrecisionRecallCurve
        >>> precision, recall, thresholds = PrecisionRecallCurve(device="cpu")(
        ...     torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 0]))
        >>> precision
        tensor([1., 1., 1.])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000])
    """

    is_differentiable = False
    higher_is_better: Optional[bool] = None
    full_state_update = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.capacity = capacity
        if capacity is not None:
            self.mode = init_score_ring_states(self, capacity, num_classes, pos_label)
        else:
            self.add_state("preds", default=[], dist_reduce_fx="cat", template=torch.zeros((0,), dtype=torch.float32))
            self.add_state("target", default=[], dist_reduce_fx="cat", template=torch.zeros((0,), dtype=torch.int32))

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        if self.capacity is not None:
            score_ring_update(self, preds, target, valid, "PrecisionRecallCurve")
            return
        reject_valid_kwarg(valid)
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        if self.capacity is not None:
            if self.mode == DataType.MULTICLASS:
                return _multiclass_precision_recall_curve_masked(
                    self.preds.data, self.target.data, self.preds.mask, self.num_classes
                )
            return _binary_precision_recall_curve_masked(self.preds.data, self.target.data, self.preds.mask)
        return _precision_recall_curve_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.num_classes, self.pos_label
        )
