"""``MinMaxMetric`` (counterpart of ``metrics_tpu/wrappers/minmax.py``)."""
from typing import Any, Dict, Union

import torch

from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class MinMaxMetric(Metric):
    """The wrapped metric's value with the least and the largest value its
    computes have returned. ``min_val`` and ``max_val`` are plain
    attributes that ``compute`` moves (not states), as in the JAX package,
    so the batch value of ``forward`` moves them too. It runs on the
    wrapped metric's device unless ``device`` says otherwise.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> metric = MinMaxMetric(MeanSquaredError(device="cpu"))
        >>> metric.update(torch.tensor([1.0]), torch.tensor([2.0]))
        >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
        {'max': 1.0, 'min': 1.0, 'raw': 1.0}
    """

    jittable_update = False
    jittable_compute = False
    full_state_update = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self._reset_extremes()

    def _reset_extremes(self) -> None:
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(
                f"Returned value from base metric should be a scalar (int, float or tensor of size 1, but got {val}"
            )
        val = torch.as_tensor(val, device=self.device)
        self.max_val = torch.maximum(self.max_val, val)
        self.min_val = torch.minimum(self.min_val, val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()
        self._reset_extremes()

    @staticmethod
    def _is_suitable_val(val: Union[int, float, Tensor]) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False
