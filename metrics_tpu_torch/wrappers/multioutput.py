"""``MultioutputWrapper`` (counterpart of ``metrics_tpu/wrappers/multioutput.py``)."""
from copy import deepcopy
from typing import Any, List, Tuple

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import apply_to_collection

Tensor = torch.Tensor

_ARRAY_TYPES = (Tensor, np.ndarray)


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """The rows holding a NaN in any of ``tensors``."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    sentinel = tensors[0]
    nan_idxs = torch.zeros(len(sentinel), dtype=torch.bool, device=sentinel.device)
    for tensor in tensors:
        nan_idxs = nan_idxs | torch.any(torch.isnan(tensor.reshape(len(sentinel), -1)), dim=1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """One copy of ``base_metric`` for each output column.

    With ``remove_nans`` (the default) a column's rows holding a NaN are
    removed before its copy updates: a boolean index, which reads the row
    count back. Without it the body only splits columns, and the pure layer
    can run it over explicit states. It runs on the base metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> metric = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
        >>> metric.update(torch.tensor([[1.0, 2.0]]), torch.tensor([[1.0, 4.0]]))
        >>> [round(float(v), 2) for v in metric.compute()]
        [0.0, 4.0]
    """

    is_differentiable = False
    jittable_update = False
    jittable_compute = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
    ) -> None:
        super().__init__(device=base_metric.device)
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs
        self._wrapper_trace_safe = not remove_nans

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[list, dict]]:
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):

            def select(x: Any, _i: int = i) -> Tensor:
                return self._to_device(x).narrow(self.output_dim, _i, 1)

            selected_args = list(apply_to_collection(args, _ARRAY_TYPES, select))
            selected_kwargs = apply_to_collection(kwargs, _ARRAY_TYPES, select)
            if self.remove_nans:
                nan_idxs = _get_nan_indices(*selected_args, *selected_kwargs.values())
                selected_args = [arg[~nan_idxs] for arg in selected_args]
                selected_kwargs = {k: v[~nan_idxs] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [arg.squeeze(self.output_dim) for arg in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> List[Tensor]:
        return [m.compute() for m in self.metrics]

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Each copy's own ``forward`` on its column."""
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs))
        ]
        if results[0] is None:
            return None
        return results

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        super().reset()
