"""``ClasswiseWrapper`` (counterpart of ``metrics_tpu/wrappers/classwise.py``)."""
from typing import Any, Dict, List, Optional

import torch

from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class ClasswiseWrapper(Metric):
    """A per-class result as a dict labelled by class. The wrapper holds no
    state: its body delegates to the wrapped metric, so the pure layer can
    run it over explicit states (``_wrapper_trace_safe``). It runs on the
    wrapped metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> metric = ClasswiseWrapper(Accuracy(num_classes=3, average=None, device="cpu"), labels=["cat", "dog", "bird"])
        >>> metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1], [0.1, 0.1, 0.8]]), torch.tensor([0, 1, 1]))
        >>> {k: round(float(v), 2) for k, v in sorted(metric.compute().items())}
        {'accuracy_bird': 0.0, 'accuracy_cat': 1.0, 'accuracy_dog': 0.5}
    """

    jittable_update = False
    jittable_compute = False
    _wrapper_trace_safe = True

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `metrics_tpu_torch.Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        super().__init__(device=metric.device)
        self.metric = metric
        self.labels = labels

    def _convert(self, x: Tensor) -> Dict[str, Any]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def reset(self) -> None:
        self.metric.reset()
        super().reset()
