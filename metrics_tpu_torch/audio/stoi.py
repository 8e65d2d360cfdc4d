"""STOI (counterpart of ``metrics_tpu/audio/stoi.py``).

Always importable; without ``pystoi`` the constructor refuses unless
``use_device_implementation=True``. The update reads its inputs back to the
host by design (VAD and resampling run there), so its capture fails and
the instance runs eagerly, as JAX's trace fails and JAX runs it eagerly.
"""
from typing import Any

import torch

from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.imports import _PYSTOI_AVAILABLE

Tensor = torch.Tensor


class ShortTimeObjectiveIntelligibility(Metric):
    """Average STOI over all seen clips."""

    full_state_update = False
    is_differentiable = False
    higher_is_better = True

    def __init__(
        self, fs: int, extended: bool = False, use_device_implementation: bool = False, **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        if not _PYSTOI_AVAILABLE and not use_device_implementation:
            raise ModuleNotFoundError(
                "ShortTimeObjectiveIntelligibility metric requires that the `pystoi` package is installed."
                " Install it with `pip install pystoi`, or pass `use_device_implementation=True`"
                " for the native JAX implementation."
            )
        self.fs = fs
        self.extended = extended
        self.use_device_implementation = use_device_implementation
        self.add_state("sum_stoi", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        stoi_batch = short_time_objective_intelligibility(
            preds, target, self.fs, self.extended, self.use_device_implementation, device=self.device
        )
        self.sum_stoi += stoi_batch.sum()
        self.total += stoi_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_stoi / self.total
