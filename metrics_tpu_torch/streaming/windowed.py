"""Sliding-window and exponentially decayed views of an accumulating metric
(counterpart of ``metrics_tpu/streaming/windowed.py``).

:class:`WindowedMetric` keeps ``buckets`` copies of the wrapped metric's
states in a ring: each update's state delta (the wrapped update run on a
fresh default state) is added into the current bucket, and a bucket that
has absorbed ``window // buckets`` rows rotates out lazily, at the start of
the next update. The rows of one update all land in the bucket current
when the update starts, so the window covers exactly the trailing
``window`` rows when batches align with the buckets
(``bucket_len % batch == 0``); a batch larger than a bucket fills one by
itself (warned once), and ``window_rows`` always says what is covered.
Wrapped states: tensors reduced by sum, mean, max or min, and the fault
counters (summed per bucket, so faults expire with their bucket).

:class:`DecayedMetric` scales its sum and mean accumulators by
``2**(-n / halflife)`` before an ``n``-row update is added, so a row's
weight halves every ``halflife`` rows. The accumulators are float32
whatever the wrapped dtype; max and min are refused; the fault counters
are not decayed.

Both refuse list, ring and sketch states, which have no per-bucket
identity. Their rings and sums are ordinary sum/max/min states: they ride
``fused_sync``'s buckets like any other. Every update is tensor operations
on the metric's device, with no read back (the warning for a batch larger
than a bucket reads a ``valid`` mask's count once, while it can still
fire).
"""
from typing import Any, Dict, Optional

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric, _clone
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utilities.guard import (
    FAULT_CLASSES,
    INFORMATIONAL_FAULT_CLASSES,
    NUM_FAULT_CLASSES,
    FaultCounters,
    actionable_fault_total,
    format_fault_report,
)
from metrics_tpu_torch.utilities.prints import rank_zero_warn
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer

Tensor = torch.Tensor

__all__ = ["WindowedMetric", "DecayedMetric"]


def _leading_rows(args: tuple, kwargs: dict) -> int:
    """The rows of one update: the leading dimension of its first array
    argument, 1 for a scalar update."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, (Tensor, np.ndarray)) and a.ndim >= 1:
            return int(a.shape[0])
    return 1


class _StreamingWrapper(Metric):
    """The state delta of a batch, the checks of the wrapped states, the
    wrapped compute on a rebuilt state, and the fault channel."""

    is_differentiable = False
    full_state_update = True  # the merge of a batch into the rings has no rule of its own
    # the pure layer runs it over explicit states, the wrapped metric's included
    _wrapper_trace_safe = True
    _KIND_NAME = "streaming wrapper"

    def __init__(self, metric: Metric, **kwargs: Any) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected the wrapped metric to be a `metrics_tpu_torch.Metric`, got {metric!r}")
        kwargs.setdefault("device", metric.device)
        super().__init__(**kwargs)
        self.wrapped = metric

    def _child_state_specs(self, allow_minmax: bool) -> Dict[str, str]:
        """``{state: kind}``, kind one of sum, mean, max, min and faults;
        raises for a state with no bucket or decay rule."""
        specs: Dict[str, str] = {}
        child = type(self.wrapped).__name__
        for name, default in self.wrapped._defaults.items():
            fx = self.wrapped._reductions[name]
            if isinstance(default, FaultCounters):
                specs[name] = "faults"
            elif isinstance(default, (list, CatBuffer)) or getattr(type(default), "is_sketch_state", False):
                raise ValueError(
                    f"{type(self).__name__} cannot wrap {child}: state {name!r} is a per-row/list/sketch state "
                    "with no per-bucket identity to expire. Wrap sum/mean/max/min-reduced metrics (use the "
                    "standalone sketches for windowed distributional views)."
                )
            elif fx in ("sum", "mean") or (fx in ("max", "min") and allow_minmax):
                specs[name] = fx
            else:
                raise ValueError(
                    f"{type(self).__name__} cannot wrap {child}: state {name!r} has dist_reduce_fx={fx!r}, "
                    f"which has no {self._KIND_NAME} rule."
                )
        return specs

    def _delta_state(self, args: tuple, kwargs: dict) -> Dict[str, Any]:
        """The wrapped update applied to a fresh default state: the batch's
        contribution, its fault counts included."""
        child = self.wrapped
        prev = child.__dict__["_state"]
        object.__setattr__(child, "_state", {k: _clone(v) for k, v in child._defaults.items()})
        try:
            child._original_update(*args, **kwargs)
            return dict(child.__dict__["_state"])
        finally:
            object.__setattr__(child, "_state", prev)

    def _run_child_compute(self, state: Dict[str, Any]) -> Any:
        child = self.wrapped
        prev = child.__dict__["_state"]
        object.__setattr__(child, "_state", state)
        try:
            return child._original_compute()
        finally:
            object.__setattr__(child, "_state", prev)

    def _aggregated_fault_counts(self) -> Optional[Tensor]:
        raise NotImplementedError

    @property
    def fault_counts(self) -> Optional[Dict[str, int]]:
        """The wrapped metric's fault counts under this wrapper's aggregation
        (windowed counts expire with their bucket, decayed ones never
        decay), plus the wrapper's own counters when it is guarded. A
        wrapper guard that only counts (``warn``/``error``) saw the rows the
        wrapped guard counted, so only its informational classes add."""
        counts = self._aggregated_fault_counts()
        own = self._state.get("_faults")
        if counts is None and own is None:
            return None
        host = np.zeros(NUM_FAULT_CLASSES, np.int64)
        if counts is not None:
            host += counts.cpu().numpy().astype(np.int64)
        if own is not None:
            own_host = own.counts.cpu().numpy().astype(np.int64)
            if counts is not None and self.on_invalid in ("warn", "error"):
                keep = np.array([name in INFORMATIONAL_FAULT_CLASSES for name in FAULT_CLASSES])
                own_host = np.where(keep, own_host, 0)
            host += own_host
        return {name: int(host[i]) for i, name in enumerate(FAULT_CLASSES)}

    def _check_faults(self) -> None:
        """The wrapped metric's ``on_invalid`` policy, applied at this
        wrapper's compute to the aggregated counts."""
        policy = getattr(self.wrapped, "on_invalid", "ignore")
        counts = self._aggregated_fault_counts()
        if policy in ("ignore", "drop") or counts is None:
            return
        host = counts.cpu().numpy().astype(np.int64)
        total = actionable_fault_total(host)
        owner = f"{type(self).__name__}({type(self.wrapped).__name__})"
        if policy == "error":
            if total > 0:
                raise MetricsTPUUserError(format_fault_report(host, owner))
            return
        if total <= self._faults_reported:
            return
        self._faults_reported = total
        rank_zero_warn(format_fault_report(host, owner), UserWarning)

    def reset(self) -> None:
        super().reset()
        self.wrapped.reset()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.wrapped!r})"


class WindowedMetric(_StreamingWrapper):
    """A sliding-window view of a sum/mean/max/min-reduced metric.

    ``WindowedMetric(Accuracy(), window=8192, buckets=8)`` reports accuracy
    over (at most) the trailing 8192 rows, from eight buckets of 1024 rows.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric, WindowedMetric
        >>> m = WindowedMetric(SumMetric(device="cpu"), window=4, buckets=2)
        >>> for v in (1.0, 2.0, 3.0, 4.0):
        ...     m.update(torch.tensor([v, v]))
        >>> float(m.compute())  # the last 4 rows: two 2-row updates of 3s and 4s
        14.0
    """

    def __init__(self, metric: Metric, window: int, buckets: int = 8, **kwargs: Any) -> None:
        super().__init__(metric, **kwargs)
        if not (isinstance(window, int) and window >= 1):
            raise ValueError(f"`window` must be a positive number of rows, got {window}")
        if not (isinstance(buckets, int) and 1 <= buckets <= window):
            raise ValueError(f"`buckets` must be an int in [1, window], got {buckets}")
        if window % buckets:
            raise ValueError(
                f"`window` ({window}) must be divisible by `buckets` ({buckets}) so every bucket covers the same row quota"
            )
        self.window = window
        self.buckets = buckets
        self.bucket_len = window // buckets
        self._specs = self._child_state_specs(allow_minmax=True)
        self._identities: Dict[str, Tensor] = {}
        for name, kind in self._specs.items():
            if kind == "faults":
                identity = torch.zeros((NUM_FAULT_CLASSES,), dtype=torch.int64, device=self.device)
                fx = "sum"
            else:
                identity = self.wrapped._defaults[name].to(self.device)
                fx = {"sum": "sum", "mean": "sum", "max": "max", "min": "min"}[kind]
            self._identities[name] = identity
            ring = identity.unsqueeze(0).repeat((buckets,) + (1,) * identity.ndim)
            self.add_state(f"win__{name}", default=ring, dist_reduce_fx=fx)
        # head and fill are the same on every rank (max keeps them); the
        # per-bucket update and row counts add up over ranks
        self.add_state("win__head", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("win__fill", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("win__n_updates", default=torch.zeros((buckets,), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("win__rows", default=torch.zeros((buckets,), dtype=torch.int32), dist_reduce_fx="sum")
        self._batch_span_warned = False

    def _warn_span(self, n: int, kwargs: dict) -> None:
        """Warn once when batches exceed a bucket's quota (real rows: a
        ``valid`` mask's count)."""
        if n <= self.bucket_len or self._batch_span_warned:
            return
        valid = kwargs.get("valid")
        n_real = int(valid.to(torch.bool).sum()) if valid is not None else n
        if n_real <= self.bucket_len:
            return
        self._batch_span_warned = True
        rank_zero_warn(
            f"{type(self).__name__}({type(self.wrapped).__name__}): update batches of {n_real} rows exceed the "
            f"{self.bucket_len}-row bucket quota (window={self.window}, buckets={self.buckets}); each batch fills "
            f"a whole bucket, so the covered span grows toward {self.buckets * n_real} rows instead of "
            f"{self.window}. Size `buckets` so window/buckets is at least the batch size (check `window_rows` "
            "for the span actually covered).",
            UserWarning,
        )

    def update(self, *args: Any, **kwargs: Any) -> None:
        n = _leading_rows(args, kwargs)
        self._warn_span(n, kwargs)
        delta = self._delta_state(args, kwargs)
        B = self.buckets
        head, fill = self.win__head, self.win__fill
        # lazy rotation: a bucket that reached its quota stays readable until
        # the next update needs its slot
        rotate = fill >= self.bucket_len
        head = torch.where(rotate, (head + 1) % B, head)
        onehot = torch.arange(B, device=self.device) == head

        def roll(ring: Tensor, identity: Tensor, kind: str, leaf: Tensor) -> Tensor:
            shape = (B,) + (1,) * (ring.ndim - 1)
            ring = torch.where((rotate & onehot).reshape(shape), identity, ring)  # expire the reused slot
            if kind == "max":
                added = torch.maximum(ring, leaf)
            elif kind == "min":
                added = torch.minimum(ring, leaf)
            else:
                added = ring + leaf
            return torch.where(onehot.reshape(shape), added, ring)

        for name, kind in self._specs.items():
            leaf = delta[name].counts if kind == "faults" else delta[name]
            ring_name = f"win__{name}"
            setattr(self, ring_name, roll(getattr(self, ring_name), self._identities[name], kind, leaf.to(self.device)))
        valid = kwargs.get("valid")
        rows = valid.to(torch.bool).sum().to(torch.int32) if valid is not None else torch.tensor(n, dtype=torch.int32, device=self.device)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        one = torch.ones((), dtype=torch.int32, device=self.device)
        self.win__n_updates = roll(self.win__n_updates, zero, "sum", one)
        self.win__rows = roll(self.win__rows, zero, "sum", rows)
        self.win__fill = torch.where(rotate, zero, fill) + rows
        self.win__head = head

    def _window_child_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        for name, kind in self._specs.items():
            ring = getattr(self, f"win__{name}")
            if kind == "sum":
                state[name] = ring.sum(dim=0)
            elif kind == "mean":
                total = torch.clamp_min(self.win__n_updates.sum(), 1)
                state[name] = ring.sum(dim=0) / total
            elif kind == "max":
                state[name] = ring.amax(dim=0)
            elif kind == "min":
                state[name] = ring.amin(dim=0)
            else:
                state[name] = FaultCounters(ring.sum(dim=0))
        return state

    def compute(self) -> Any:
        return self._run_child_compute(self._window_child_state())

    @property
    def window_rows(self) -> int:
        """The rows the window covers now (reads it back)."""
        return int(self.win__rows.sum())

    def _aggregated_fault_counts(self) -> Optional[Tensor]:
        ring = self._state.get("win___faults")
        return None if ring is None else ring.sum(dim=0)


class DecayedMetric(_StreamingWrapper):
    """An exponentially decayed view of a sum/mean-reduced metric: each row's
    weight halves every ``halflife`` rows.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import DecayedMetric, MeanMetric
        >>> m = DecayedMetric(MeanMetric(nan_strategy="ignore", device="cpu"), halflife=1.0)
        >>> for v in (0.0, 0.0, 1.0):
        ...     m.update(torch.tensor([v]))
        >>> round(float(m.compute()), 4)  # weights 2^-2, 2^-1, 1 -> 4/7
        0.5714
    """

    _KIND_NAME = "decay"

    def __init__(self, metric: Metric, halflife: float, **kwargs: Any) -> None:
        super().__init__(metric, **kwargs)
        if not (float(halflife) > 0):
            raise ValueError(f"`halflife` must be a positive number of rows, got {halflife}")
        self.halflife = float(halflife)
        self._specs = self._child_state_specs(allow_minmax=False)
        for name, kind in self._specs.items():
            if kind == "faults":
                default = torch.zeros((NUM_FAULT_CLASSES,), dtype=torch.int64)
            else:
                # a decayed accumulator is fractional
                default = torch.zeros(self.wrapped._defaults[name].shape, dtype=torch.float32)
            self.add_state(f"dec__{name}", default=default, dist_reduce_fx="sum")
        self.add_state("dec__n_updates", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, *args: Any, **kwargs: Any) -> None:
        n = _leading_rows(args, kwargs)
        delta = self._delta_state(args, kwargs)
        valid = kwargs.get("valid")
        if valid is not None:
            # masked rows age nothing
            rows = valid.to(torch.bool).sum().to(torch.float32)
            factor = torch.exp2(-rows / self.halflife)
        else:
            factor = torch.tensor(2.0 ** (-n / self.halflife), dtype=torch.float32, device=self.device)
        for name, kind in self._specs.items():
            dec_name = f"dec__{name}"
            if kind == "faults":
                # the evidence of faults does not fade
                setattr(self, dec_name, getattr(self, dec_name) + delta[name].counts.to(self.device))
            else:
                # one fused multiply-add, as XLA contracts the JAX package's
                setattr(self, dec_name, torch.addcmul(delta[name].to(self.device, torch.float32), getattr(self, dec_name), factor))
        self.dec__n_updates = torch.addcmul(torch.ones_like(self.dec__n_updates), self.dec__n_updates, factor)

    def _decayed_child_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        for name, kind in self._specs.items():
            dec = getattr(self, f"dec__{name}")
            if kind == "faults":
                state[name] = FaultCounters(dec)
            elif kind == "mean":
                state[name] = dec / torch.clamp_min(self.dec__n_updates, 1e-30)
            else:
                state[name] = dec
        return state

    def compute(self) -> Any:
        return self._run_child_compute(self._decayed_child_state())

    def _aggregated_fault_counts(self) -> Optional[Tensor]:
        return self._state.get("dec___faults")
