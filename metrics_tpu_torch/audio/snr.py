"""SNR and SI-SNR (counterpart of ``metrics_tpu/audio/snr.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class SignalNoiseRatio(Metric):
    """Average SNR over all seen clips.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> metric = SignalNoiseRatio(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        16.1805
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_snr", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        snr_batch = signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr += snr_batch.sum()
        self.total += snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_snr / self.total


class ScaleInvariantSignalNoiseRatio(Metric):
    """Average SI-SNR over all seen clips.

    Example:
        >>> import torch
        >>> metric = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(metric(preds, target)), 4)
        15.0918
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds=preds, target=target)
        self.sum_si_snr += si_snr_batch.sum()
        self.total += si_snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_snr / self.total
