"""``AUROC`` (counterpart of ``metrics_tpu/classification/auroc.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.auroc import (
    _auroc_compute,
    _auroc_update,
    _binary_auroc_masked,
    _multiclass_auroc_masked,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType
from metrics_tpu_torch.utilities.ringbuffer import init_score_ring_states, reject_valid_kwarg, score_ring_update

Tensor = torch.Tensor


class AUROC(Metric):
    """Area under the ROC curve.

    Two accumulation modes:

    - default: the scores and labels accumulate in ``cat`` list states and
      ``compute`` runs the exact curve on their concatenation;
    - ``capacity=N``: fixed-size ``CatBuffer`` rings; ``compute`` is the
      tie-averaged rank statistic, equal to the trapezoid ROC area. Rows past
      capacity are dropped and counted (``on_overflow``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC
        >>> metric = AUROC(device="cpu")
        >>> round(float(metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 0]))), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _snapshot_attrs = ("mode",)  # inferred from the data at update

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr
        self.capacity = capacity

        allowed_average = (AverageMethod.MICRO, AverageMethod.MACRO, AverageMethod.WEIGHTED, AverageMethod.NONE, None, "none")
        if average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        if capacity is not None:
            # the data mode is fixed at construction: binary unless
            # num_classes declares one-vs-rest multiclass
            if max_fpr is not None:
                raise ValueError("`max_fpr` is not supported together with `capacity` (static-shape) mode")
            if average == AverageMethod.MICRO:
                raise ValueError("`average='micro'` is not supported together with `capacity` mode")
            self.mode = init_score_ring_states(self, capacity, num_classes, pos_label)
        else:
            self.mode: Optional[DataType] = None
            self.add_state("preds", default=[], dist_reduce_fx="cat", template=torch.zeros((0,), dtype=torch.float32))
            self.add_state("target", default=[], dist_reduce_fx="cat", template=torch.zeros((0,), dtype=torch.int32))

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        """``valid`` (capacity mode only) is a per-row bool mask: a rank can
        then contribute fewer rows than its block holds."""
        if self.capacity is not None:
            score_ring_update(self, preds, target, valid, "AUROC")
            return
        reject_valid_kwarg(valid)
        preds, target, mode = _auroc_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)
        if self.mode and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> Tensor:
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        if self.capacity is not None:
            if self.mode == DataType.MULTICLASS:
                return _multiclass_auroc_masked(
                    self.preds.data, self.target.data, self.preds.mask, self.num_classes, self.average
                )
            return _binary_auroc_masked(self.preds.data, self.target.data, self.preds.mask)
        return _auroc_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.mode, self.num_classes, self.pos_label,
            self.average, self.max_fpr,
        )
