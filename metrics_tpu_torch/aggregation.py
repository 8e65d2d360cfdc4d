"""Counterpart of ``metrics_tpu/aggregation.py``: the aggregation metrics,
running max, min, sum, mean and concatenation.

NaN handling masks with ``torch.where`` and reads nothing back, except
where a strategy's contract needs the value: ``nan_strategy="error"``
raises at the update, and the list form of :class:`CatMetric` removes NaN
rows by boolean indexing. ``nan_strategy="warn"`` rides the fault channel
(``on_invalid="warn"``, ``utilities/guard.py``): the rows are masked, the
NaN count goes into the ``_faults`` state, and the warning comes at
``compute()`` from the synced count. The list form of :class:`CatMetric`
keeps the warning at the update.

A NaN in a value or in its weight masks the whole row.
"""
import warnings
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append

Tensor = torch.Tensor


class BaseAggregator(Metric):
    """Base of the value aggregators."""

    is_differentiable = None
    higher_is_better = None
    full_state_update = False

    # the update itself masks or imputes NaN values, so the guard's drop
    # policy only counts; and it counts NaN only (inf is a value here)
    _guard_handles_drop = True
    _guard_nan_only = True

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, list],
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        allowed = ("error", "warn", "ignore")
        is_float = isinstance(nan_strategy, (int, float)) and not isinstance(nan_strategy, bool)
        if not is_float and nan_strategy not in allowed:
            raise ValueError(f"Arg `nan_strategy` should either be a float or one of {allowed} but got {nan_strategy}")
        if nan_strategy == "warn" and "on_invalid" not in kwargs and getattr(self, "capacity", True) is not None:
            # 'warn' counts in the fault channel and warns at compute(); the
            # list form of CatMetric keeps its warning at the update
            kwargs["on_invalid"] = "warn"
        super().__init__(**kwargs)
        self.nan_strategy = nan_strategy
        template = torch.zeros((0,), dtype=torch.float32) if isinstance(default_value, list) else None
        self.add_state("value", default=default_value, dist_reduce_fx=fn, template=template)
        if nan_strategy == "error" or (nan_strategy == "warn" and self.on_invalid == "ignore") or isinstance(default_value, list):
            # the update reads values back to raise or warn, or removes NaN
            # rows from a list (a shape that depends on the data)
            self.jittable_update = False

    def _as_float(self, x: Union[float, Tensor]) -> Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.float32)

    def _cast_and_nan_check_input(self, x: Union[float, Tensor], weight: Union[float, Tensor, None] = None):
        """Mask NaN rows as ``nan_strategy`` says: ``"error"`` raises,
        ``"warn"`` and ``"ignore"`` replace the value by the reduction's
        neutral value and the weight by 0, a float replaces a NaN value by
        itself (a NaN weight by 0)."""
        x = self._as_float(x)
        if weight is not None:
            weight = torch.broadcast_to(self._as_float(weight), x.shape)
        nans = torch.isnan(x)
        bad = nans if weight is None else (nans | torch.isnan(weight))
        if self.nan_strategy == "error":
            if bool(bad.any()):
                raise RuntimeError("Encountered `nan` values in tensor")
        elif self.nan_strategy in ("warn", "ignore"):
            if self.nan_strategy == "warn" and self.on_invalid == "ignore" and bool(bad.any()):
                warnings.warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
            x = torch.where(bad, self._neutral_value(), x)
            if weight is not None:
                weight = torch.where(bad, 0.0, weight)
        else:
            x = torch.where(nans, float(self.nan_strategy), x)
            if weight is not None:
                weight = torch.where(torch.isnan(weight), 0.0, weight)
        return x, weight

    def _neutral_value(self) -> float:
        return 0.0

    def update(self, value: Union[float, Tensor]) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def compute(self) -> Tensor:
        return self.value


class MaxMetric(BaseAggregator):
    """Running max.

    Example:
        >>> import torch
        >>> m = MaxMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 5.0, 2.0]))
        >>> m.compute()
        tensor(5.)
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(float("-inf")), nan_strategy, **kwargs)

    def _neutral_value(self) -> float:
        return float("-inf")

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        self.value = torch.maximum(self.value, value.max() if value.ndim > 0 else value)


class MinMetric(BaseAggregator):
    """Running min.

    Example:
        >>> import torch
        >>> m = MinMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 5.0, 2.0]))
        >>> m.compute()
        tensor(1.)
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, **kwargs)

    def _neutral_value(self) -> float:
        return float("inf")

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        self.value = torch.minimum(self.value, value.min() if value.ndim > 0 else value)


class SumMetric(BaseAggregator):
    """Running sum.

    Example:
        >>> import torch
        >>> m = SumMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 5.0, 2.0]))
        >>> m.compute()
        tensor(8.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        self.value = self.value + value.sum()


class CatMetric(BaseAggregator):
    """Every value seen, concatenated.

    With ``capacity=N`` the state is a :class:`CatBuffer` ring: a NaN row is
    masked instead of removed, and ``compute()`` returns the whole
    ``(capacity,)`` buffer with NaN in the slots that hold no value.

    Example:
        >>> import torch
        >>> m = CatMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 2.0]))
        >>> m.update(torch.tensor([3.0]))
        >>> m.compute()
        tensor([1., 2., 3.])
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", capacity: Optional[int] = None, **kwargs: Any) -> None:
        self.capacity = capacity
        default = [] if capacity is None else CatBuffer.zeros(capacity, (), torch.float32)
        super().__init__("cat", default, nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        x = self._as_float(value).reshape(-1)
        nans = torch.isnan(x)
        eager_check = self.nan_strategy == "error" or (self.nan_strategy == "warn" and self.on_invalid == "ignore")
        if eager_check and bool(nans.any()):
            if self.nan_strategy == "error":
                raise RuntimeError("Encountered `nan` values in tensor")
            warnings.warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
        float_strategy = self.nan_strategy not in ("error", "warn", "ignore")
        if self.capacity is not None:
            if float_strategy:
                self.value = cat_append(self.value, torch.where(nans, float(self.nan_strategy), x))
            else:
                self.value = cat_append(self.value, x, ~nans)
            return
        x = torch.where(nans, float(self.nan_strategy), x) if float_strategy else x[~nans]
        if x.numel() > 0:
            self.value.append(x)

    def compute(self) -> Tensor:
        if self.capacity is not None:
            return torch.where(self.value.mask, self.value.data, float("nan"))
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value if not isinstance(self.value, list) else torch.zeros(0, device=self.device)


class MeanMetric(BaseAggregator):
    """Weighted running mean. A merge (``forward``, or a sync) adds the
    value and weight sums, so it weighs each part by its count.

    Example:
        >>> import torch
        >>> m = MeanMetric(device="cpu")
        >>> m.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> m.compute()
        tensor(2.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value = torch.atleast_1d(self._as_float(value))
        value, weight = self._cast_and_nan_check_input(value, weight)
        self.value = self.value + torch.sum(value * weight)
        self.weight = self.weight + torch.sum(weight)

    def compute(self) -> Tensor:
        return self.value / self.weight
