"""``CalibrationError`` (counterpart of
``metrics_tpu/classification/calibration_error.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.calibration_error import (
    _NORMS,
    _ce_bin_update,
    _ce_compute,
    _ce_compute_from_bins,
    _ce_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat, jax_linspace
from metrics_tpu_torch.utilities.ringbuffer import reject_valid_kwarg

Tensor = torch.Tensor


class CalibrationError(Metric):
    """Top-label calibration error, in one of two modes:

    - by default the confidences and accuracies accumulate in ``cat`` list
      states and are binned at ``compute()``;
    - ``binned=True`` keeps ``(n_bins,)`` float32 count, confidence and
      accuracy sums, binned at each update by the same code, so both modes
      give the same value; an update then takes a ``valid`` row mask.

    On the card the binned sums add with atomics: the confidence and
    accuracy sums may differ in their last bits from run to run.

    Example:
        >>> import torch
        >>> metric = CalibrationError(n_bins=3, device="cpu")
        >>> conf = torch.tensor([0.9, 0.6, 0.3, 0.8])
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> round(float(metric(conf, target)), 4)
        0.35
        >>> binned = CalibrationError(n_bins=3, binned=True, device="cpu")
        >>> binned.update(conf, target)
        >>> round(float(binned.compute()), 4)
        0.35
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    DISTANCES = set(_NORMS)

    def __init__(self, n_bins: int = 15, norm: str = "l1", binned: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if norm not in self.DISTANCES:
            raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
        self.n_bins = n_bins
        self.norm = norm
        self.binned = bool(binned)
        self.bin_boundaries = jax_linspace(0.0, 1.0, n_bins + 1, device=self.device)
        if self.binned:
            zeros = torch.zeros((n_bins,), dtype=torch.float32)
            self.add_state("bin_count", default=zeros, dist_reduce_fx="sum")
            self.add_state("bin_conf", default=zeros, dist_reduce_fx="sum")
            self.add_state("bin_acc", default=zeros, dist_reduce_fx="sum")
        else:
            template = torch.zeros((0,), dtype=torch.float32)
            self.add_state("confidences", default=[], dist_reduce_fx="cat", template=template)
            self.add_state("accuracies", default=[], dist_reduce_fx="cat", template=template)

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        """``valid`` (bool ``(N,)``) is taken in binned mode only."""
        confidences, accuracies = _ce_update(preds, target)
        if self.binned:
            count, conf, acc = _ce_bin_update(confidences, accuracies, self.n_bins, valid, boundaries=self.bin_boundaries)
            self.bin_count += count
            self.bin_conf += conf
            self.bin_acc += acc
            return
        reject_valid_kwarg(valid)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)

    def compute(self) -> Tensor:
        if self.binned:
            return _ce_compute_from_bins(self.bin_count, self.bin_conf, self.bin_acc, norm=self.norm)
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, self.bin_boundaries.to(confidences.device), norm=self.norm)
