"""SDR and SI-SDR (counterpart of ``metrics_tpu/audio/sdr.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio, signal_distortion_ratio
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class SignalDistortionRatio(Metric):
    """Average SDR over all seen clips (dense solve, or ``use_cg_iter``
    conjugate-gradient steps). The update reads nothing back.

    Example:
        >>> import torch
        >>> g = torch.Generator().manual_seed(1)
        >>> target = torch.randn(2, 800, generator=g)
        >>> metric = SignalDistortionRatio(filter_length=64, device="cpu")
        >>> metric.update(target + 0.1 * torch.randn(2, 800, generator=g), target)
        >>> bool(metric.compute() > 15)
        True
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr += sdr_batch.sum()
        self.total += sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_sdr / self.total


class ScaleInvariantSignalDistortionRatio(Metric):
    """Average SI-SDR over all seen clips.

    Example:
        >>> import torch
        >>> metric = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(metric(preds, target)), 4)
        18.403
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr += si_sdr_batch.sum()
        self.total += si_sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_sdr / self.total
