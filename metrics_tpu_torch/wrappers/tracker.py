"""``MetricTracker`` (counterpart of ``metrics_tpu/wrappers/tracker.py``)."""
import warnings
from copy import deepcopy
from typing import Any, Dict, List, Tuple, Union

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor

# what reading a best value off a result that is not a scalar raises
_NOT_SCALAR = (ValueError, TypeError, RuntimeError)


class MetricTracker:
    """A metric (or collection) over steps such as epochs: ``increment()``
    starts a fresh copy, ``update``/``forward``/``compute`` go to the newest
    one, and ``best_metric`` reads the best step.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> tracker = MetricTracker(MeanSquaredError(device="cpu"), maximize=False)
        >>> for preds, target in [([1.0], [2.0]), ([1.0], [1.5])]:
        ...     tracker.increment()
        ...     tracker.update(torch.tensor(preds), torch.tensor(target))
        >>> round(float(tracker.best_metric()), 4)
        0.25
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                f"Metric arg need to be an instance of a metrics_tpu_torch `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        self.maximize = maximize
        self._metrics: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        return len(self._metrics)

    def increment(self) -> None:
        self._increment_called = True
        self._metrics.append(deepcopy(self._base_metric))

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._metrics[-1](*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Union[Tensor, Dict[str, Tensor]]:
        """Every step's value, stacked along dim 0 (for a collection, per
        key)."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._metrics]
        if isinstance(self._base_metric, MetricCollection):
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in res[0]}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def reset(self) -> None:
        self._metrics[-1].reset()

    def reset_all(self) -> None:
        for metric in self._metrics:
            metric.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[None, float, Tuple[int, float], Dict[str, Any], Tuple[Dict[str, Any], Dict[str, Any]]]:
        """The best value over the steps (largest with ``maximize``), and
        with ``return_step`` its step; None, with a warning, where the
        values are not scalars."""
        if isinstance(self._base_metric, Metric):
            fn = torch.argmax if self.maximize else torch.argmin
            try:
                all_res = self.compute_all()
                idx = int(fn(all_res))
                best = float(all_res[idx])
                if return_step:
                    return idx, best
                return best
            except _NOT_SCALAR as error:
                warnings.warn(
                    f"Encountered the following error when trying to get the best metric: {error}"
                    "this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.",
                    UserWarning,
                )
                if return_step:
                    return None, None
                return None

        res = self.compute_all()
        maximize = self.maximize if isinstance(self.maximize, list) else len(res) * [self.maximize]
        idx, best = {}, {}
        for i, (k, v) in enumerate(res.items()):
            try:
                fn = torch.argmax if maximize[i] else torch.argmin
                best_i = int(fn(v))
                idx[k], best[k] = best_i, float(v[best_i])
            except _NOT_SCALAR as error:
                warnings.warn(
                    f"Encountered the following error when trying to get the best metric for metric {k}:"
                    f"{error} this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.",
                    UserWarning,
                )
                idx[k], best[k] = None, None
        if return_step:
            return idx, best
        return best

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")
