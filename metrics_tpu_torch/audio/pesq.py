"""PESQ (counterpart of ``metrics_tpu/audio/pesq.py``).

Always importable; without the ``pesq`` package the constructor refuses
with the JAX package's message. The update scores on the host (the
package's C implementation), so its capture fails and it runs eagerly.
"""
from typing import Any

import torch

from metrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE

Tensor = torch.Tensor


class PerceptualEvaluationSpeechQuality(Metric):
    """Average PESQ over all seen clips."""

    full_state_update = False
    is_differentiable = False
    higher_is_better = True

    def __init__(self, fs: int, mode: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that the `pesq` package is installed."
                " Install it with `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.mode = mode
        self.add_state("sum_pesq", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pesq_batch = perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, device=self.device)
        self.sum_pesq += pesq_batch.sum()
        self.total += pesq_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_pesq / self.total
