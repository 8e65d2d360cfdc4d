"""Permutation-invariant training (counterpart of ``metrics_tpu/audio/pit.py``)."""
import inspect
from typing import Any, Callable, Dict

import torch

from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor

# the keyword arguments the base Metric takes; the rest go to metric_func
_BASE_KWARGS = tuple(
    name for name, p in inspect.signature(Metric.__init__).parameters.items()
    if name != "self" and p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD
)


class PermutationInvariantTraining(Metric):
    """Average best-permutation metric.

    ``higher_is_better`` is True, as in the JAX package. Keyword arguments
    that the base ``Metric`` does not take (``device=`` and the sync
    options are its own) go to ``metric_func`` on every update.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio import (
        ...     permutation_invariant_training, scale_invariant_signal_distortion_ratio)
        >>> preds = torch.tensor([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]])   # (batch, spk, time)
        >>> target = torch.tensor([[[4.0, 5.0, 6.0], [1.0, 2.0, 3.0]]])  # speakers swapped
        >>> best, perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio, "max")
        >>> perm.tolist()
        [[1, 0]]
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True

    def __init__(self, metric_func: Callable, eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs: Dict[str, Any] = {key: kwargs.pop(key) for key in _BASE_KWARGS if key in kwargs}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pit_metric = permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self.sum_pit_metric += pit_metric.sum()
        self.total += pit_metric.numel()

    def compute(self) -> Tensor:
        return self.sum_pit_metric / self.total
