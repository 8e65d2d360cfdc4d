"""The ``Metric`` runtime (counterpart of ``metrics_tpu/metric.py``).

A metric holds named state tensors on one device, registered with
:meth:`Metric.add_state`. ``update`` accumulates a batch into them,
``compute`` turns them into a value, and ``forward`` does both, returning the
batch's own value.

The device is explicit: ``Metric(device=None)`` means ``"cuda"`` and raises
where there is no CUDA device, so a metric never runs on the CPU unless the
caller asks for ``device="cpu"``.

Subclass code may update states in place (``self.tp += tp``). The runtime
therefore clones wherever it keeps a state for later or hands one out:
defaults on reset, the saved state in ``forward``, ``state_dict``,
``metric_state``, and every value that ``load_state_dict`` takes in. No
tensor is shared between two owners (the compute groups of a
``MetricCollection`` share their head's state on purpose).

A state is a tensor, a list of tensors (a ``cat`` state), a
:class:`~metrics_tpu_torch.utilities.ringbuffer.CatBuffer` ring (a ``cat``
state of fixed capacity), or a sketch state (``streaming/sketches.py``): a
NamedTuple of tensors whose class sets ``is_sketch_state``. A sketch state
merges through its own ``sketch_merge`` and is saved and loaded through
``to_primitives``/``from_primitives``.

In a ``torch.distributed`` world of more than one process, ``compute()``
syncs every state over the metric's ``process_group`` with
:func:`~metrics_tpu_torch.parallel.sync.fused_sync` (one ``all_reduce`` per
(reduction, dtype) bucket, a gather for ``cat`` states; ``dist_sync_fn``
is a communicator in place of ``torch.distributed``, stated difference
D15), computes, and restores the local state. A blocking sync is always
exact. A collective that cannot complete degrades the sync to this rank's
own state, loudly (``parallel/sync.py::RetryingGather``).

The overlapped mode (``sync_mode="overlapped"``, ``parallel/async_sync.py``):
every ``sync_every_n`` updates the state is cloned, on the thread and the
stream that ran them, and a worker thread syncs the clone and publishes it
as a view; ``compute()`` computes from the view with no collective,
``compute(fresh=True)`` takes the blocking sync, and ``forward`` returns the
batch's own value. ``sync_transport`` (``int8``/``fp16``) ships the cycle's
float leaves quantized (``ops/quantize.py``); blocking syncs stay exact. On
the card the cycle runs on a stream of its own after the clone's event, and
a read waits on the view's event. ``reset``, ``clone``, deepcopy and
pickling drop the scheduler and its thread.

The compiled update (``_capture.py``, the counterpart of
``_make_update_jit``): on a CUDA metric whose update can be compiled
(``jittable_update``, no list state) and that neither computes on the CPU
nor runs ``debug_checks``, the first update at a key (argument shapes, the
data-inferred attributes, the states' identity) runs eagerly with the value
checks, the next captures the update into a CUDA graph, and every later one
replays it. A capture that fails turns ``jittable_update`` off and runs the
update eagerly. ``forward``'s updates and ``compute`` stay eager.
``debug_checks=True`` keeps the update eager and fails after it when a
float state holds NaN or an infinity (one read back).

The fault channel (``on_invalid``, ``utilities/guard.py``): with a policy
other than ``"ignore"`` every update is validated by tensor ops, the faults
are counted in the ``_faults`` sum state, ``"drop"`` masks the offending
rows, and ``"warn"``/``"error"`` act at ``compute()`` from the synced
counts. Such an update runs without the value checks of
``utilities/checks.py`` and reads nothing back; so does a captured update
(stated difference D1).

The padding ladder (``pad_batches=True``, ``ops/padding.py``): every update
batch pads up to a ladder tier on its own device, the pad rows masked
through the ``valid`` row mask (a metric that cannot consume one is
refused at its first update) and counted in the fault channel's
informational ``padded_rows`` class.

Constructor knobs, with the JAX package's meaning: ``compute_on_cpu`` moves
the list (``cat``) states to host memory after each update and computes
from host copies of every state (the value lies on the CPU; a sync first
brings the lists back to the metric's device); ``dist_sync_on_step`` syncs
the batch value of ``forward`` across processes (every rank must then call
``forward`` in step); ``sync_on_compute=False`` computes the local value.

Metric arithmetic (``a + b``, ``2 * p * r / (p + r)``, ``m[0]``) builds a
:class:`CompositionalMetric`, which updates, resets and computes its
operands. The overloads include ``==``, so a metric hashes by identity
(stated difference D22). :meth:`Metric.snapshot_state` and
:meth:`Metric.load_snapshot_state` save and restore every state of the
whole tree of metrics, validated before anything is committed, in a form
that the JAX package's ``load_snapshot_state`` reads, and the reverse.
"""
import contextlib
import functools
import inspect
import operator
import threading
import time
from copy import deepcopy
from enum import Enum
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from metrics_tpu_torch._capture import UpdateGraphs, capturing
from metrics_tpu_torch.analysis.lockwitness import named_lock
from metrics_tpu_torch.obs import trace as _obs_trace
from metrics_tpu_torch.ops.padding import pad_update_args
from metrics_tpu_torch.ops.quantize import resolve_codec, validate_transport
from metrics_tpu_torch.parallel.sync import distributed_available, fused_sync
from metrics_tpu_torch.utilities import enums
from metrics_tpu_torch.utilities.checks import value_checks_off
from metrics_tpu_torch.utilities.data import _squeeze_if_scalar, _tensor_leaves
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utilities.guard import (
    _IDX,
    NUM_FAULT_CLASSES,
    VALID_POLICIES,
    FaultCounters,
    actionable_fault_total,
    format_fault_report,
    guard_update_args,
    nan_state_leaves,
)
from metrics_tpu_torch.utilities.prints import rank_zero_warn
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append

Tensor = torch.Tensor
Reduction = Union[str, Callable, None]

# attributes rebuilt per instance, never copied or pickled: the bound
# methods, and the overlapped mode's scheduler, lock and streams
_BOUND = ("update", "compute", "_original_update", "_original_compute", "_update_signature")
_PER_INSTANCE = _BOUND + (
    "_sync_scheduler", "_overlap_lock", "_sync_view_key", "_update_stream", "_side_stream", "_in_forward", "_update_graphs",
)


def jit_distributed_available() -> bool:
    """Whether a sync would run (the JAX package's name for it)."""
    return distributed_available()


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means CUDA; asking for CUDA where there is none raises, and
    so does ``None`` under ``METRICS_TPU_FORCE_CPU`` or after a failed
    bootstrap probe (``utilities/backend.py``): nothing moves to the CPU
    unless asked to."""
    if device is None:
        from metrics_tpu_torch.utilities.backend import device_refusal

        refusal = device_refusal()
        if refusal is not None:
            raise MetricsTPUUserError(f"This metric runs on CUDA by default, and {refusal}.")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MetricsTPUUserError(
            "This metric runs on CUDA by default, and no CUDA device is available. "
            "Pass device='cpu' to run it on the CPU."
        )
    return device


def _is_sketch_state(value: Any) -> bool:
    return getattr(type(value), "is_sketch_state", False)


def _is_tuple_state(value: Any) -> bool:
    """A state held as a NamedTuple of tensors: a sketch state, a ring or
    the fault counters."""
    return isinstance(value, (CatBuffer, FaultCounters)) or _is_sketch_state(value)


def _map_state(fn: Callable[[Tensor], Tensor], value: Any) -> Any:
    """``fn`` over every tensor of a state: a tensor, a list, a ring or a
    sketch state."""
    if isinstance(value, list):
        return [fn(v) for v in value]
    if _is_tuple_state(value):
        return type(value)(*(fn(v) for v in value))
    return fn(value)


def _clone(value: Any) -> Any:
    return _map_state(torch.Tensor.clone, value)


def _cuda_leaves(state: Dict[str, Any]) -> list:
    return [t for v in state.values() for t in _tensor_leaves(v) if t.is_cuda]


def _record_event(state: Dict[str, Any], stream: Optional[Any]) -> Optional[Any]:
    """An event recorded on ``stream`` after the work that made ``state``
    (None for CPU states)."""
    if stream is None or not _cuda_leaves(state):
        return None
    return stream.record_event()


def _use_on_current_stream(state: Dict[str, Any], event: Optional[Any]) -> None:
    """Make the current CUDA stream wait for ``event`` and mark the state's
    tensors as used by it, so the allocator does not hand their memory to
    another stream too early."""
    leaves = _cuda_leaves(state)
    if event is None or not leaves:
        return
    current = torch.cuda.current_stream(leaves[0].device)
    current.wait_event(event)
    for t in leaves:
        t.record_stream(current)


_NO_SYNC_VIEW = object()


@contextlib.contextmanager
def _on_stream(stream: Optional[Any]) -> Iterator[None]:
    if stream is None:
        yield
    else:
        with torch.cuda.stream(stream):
            yield


def _cycle_error_recorder(name: str) -> Callable[[BaseException], None]:
    """The scheduler's ``on_error``: a failed cycle keeps the previous view
    and records an ``async_sync_error`` health event."""

    def on_error(err: BaseException) -> None:
        from metrics_tpu_torch.resilience.health import record_degradation

        record_degradation(
            "async_sync_error", f"overlapped sync cycle for {name} raised {type(err).__name__}: {err}", metric=name
        )

    return on_error


class Metric:
    """Base class for all metrics."""

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    # whether ``update`` and ``compute`` run on tensors alone, without
    # reading values back to decide what to do; the pure layer
    # (``pure.py``) refuses a metric that declares either False, and an
    # update is captured only while ``jittable_update`` holds (a failed
    # capture turns it off on the instance, as a failed trace does in the
    # JAX package)
    jittable_update: bool = True
    jittable_compute: bool = True

    # attributes that an update infers from the data (an input mode), which
    # a snapshot carries so that a fresh instance computes right after a
    # restore
    _snapshot_attrs: Sequence[str] = ()

    # how the ``CatBuffer`` rings overflow together: False for rings filled
    # in lockstep (preds and target drop the same rows, counted once), True
    # for rings filled independently (their drops add up)
    _independent_ring_drops: bool = False

    def __init__(
        self,
        device: Union[str, torch.device, None] = None,
        compute_on_cpu: bool = False,
        dist_sync_on_step: bool = False,
        sync_on_compute: bool = True,
        on_overflow: str = "warn",
        on_invalid: str = "ignore",
        debug_checks: bool = False,
        pad_batches: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        sync_mode: str = "blocking",
        sync_every_n: Optional[int] = None,
        sync_every_s: Optional[float] = None,
        sync_transport: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        object.__setattr__(self, "_state", {})
        object.__setattr__(self, "_defaults", {})
        object.__setattr__(self, "_reductions", {})
        object.__setattr__(self, "_persistent", {})
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {list(kwargs)}")
        self.device = resolve_device(device)
        self.compute_on_cpu = compute_on_cpu
        self.dist_sync_on_step = dist_sync_on_step
        self.sync_on_compute = sync_on_compute
        if on_overflow not in ("warn", "error", "ignore"):
            raise ValueError(f"`on_overflow` must be 'warn', 'error' or 'ignore', got {on_overflow!r}")
        # what compute() does when a state has run past its capacity
        # (see _check_cat_overflow)
        self.on_overflow = on_overflow
        if on_invalid not in VALID_POLICIES:
            raise ValueError(f"`on_invalid` must be one of {VALID_POLICIES}, got {on_invalid!r}")
        # what an update does with invalid rows, and compute() with their
        # counts (utilities/guard.py)
        self.on_invalid = on_invalid
        # strict mode: eager updates, each followed by a check that no float
        # state holds NaN or an infinity
        self.debug_checks = bool(debug_checks)
        # the fault total that the warn policy last reported
        self._faults_reported = 0
        # the padding ladder (ops/padding.py): every update batch pads up to
        # a ladder tier, its pad rows masked through ``valid`` and counted
        # in the fault channel's informational ``padded_rows`` class
        self.pad_batches = bool(pad_batches)
        # the multi-process sync: the group to sync over, and optionally a
        # communicator that replaces ``torch.distributed`` (an object with
        # its all_reduce, all_gather, get_world_size and get_rank)
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None
        # the overlapped mode (parallel/async_sync.py)
        if sync_mode not in ("blocking", "overlapped"):
            raise ValueError(f"`sync_mode` must be 'blocking' or 'overlapped', got {sync_mode!r}")
        self.sync_mode = sync_mode
        if sync_mode == "overlapped":
            from metrics_tpu_torch.parallel.async_sync import resolve_sync_cadence

            self.sync_every_n, self.sync_every_s = resolve_sync_cadence(sync_every_n, sync_every_s)
        else:
            if sync_every_n is not None or sync_every_s is not None:
                raise ValueError("`sync_every_n`/`sync_every_s` need sync_mode='overlapped'")
            self.sync_every_n = None
            self.sync_every_s = None
        validate_transport(sync_transport)
        if sync_transport not in (None, "exact") and sync_mode != "overlapped":
            raise ValueError("`sync_transport` needs sync_mode='overlapped' (the blocking sync path is always exact)")
        self.sync_transport = sync_transport
        self._init_overlap()

        self._update_count = 0
        self._update_called = False
        # wall-clock time of the last update (health_report's staleness)
        self._last_update_unix: Optional[float] = None
        self._computed: Any = None
        self._forward_cache: Any = None
        # False only inside forward: its batch value is local by design
        self._to_sync = True

        self._wrap_methods()
        if on_invalid != "ignore" or self.pad_batches:
            self.add_state("_faults", default=FaultCounters.zeros(), dist_reduce_fx="sum")

    def _init_overlap(self) -> None:
        """The per-instance parts of the overlapped mode: no scheduler yet,
        and one lock around every window in which ``_state`` changes or is
        swapped, so a cycle never clones a half-made state."""
        object.__setattr__(self, "_sync_scheduler", None)
        object.__setattr__(self, "_sync_view_key", None)
        object.__setattr__(self, "_update_stream", None)
        object.__setattr__(self, "_side_stream", None)
        object.__setattr__(self, "_in_forward", False)
        overlapped = self.__dict__.get("sync_mode") == "overlapped"
        lock = named_lock("metric._overlap_lock", threading.RLock()) if overlapped else None
        object.__setattr__(self, "_overlap_lock", lock)

    def _state_swap_guard(self):
        lock = self.__dict__.get("_overlap_lock")
        return lock if lock is not None else contextlib.nullcontext()

    def _wrap_methods(self) -> None:
        object.__setattr__(self, "_original_update", self._maybe_guard(type(self).update.__get__(self)))
        object.__setattr__(self, "_original_compute", type(self).compute.__get__(self))
        object.__setattr__(self, "update", self._wrap_update(self._original_update))
        object.__setattr__(self, "compute", self._wrap_compute(self._original_compute))
        self._update_signature = inspect.signature(self._original_update)

    def _maybe_guard(self, update: Callable) -> Callable:
        """The update behind the fault channel: its arguments validated,
        masked by the policy and counted into ``_faults``, and the body run
        without the value checks (nothing is read back). ``"ignore"``
        returns the update as it is. Attributes are read at call time: a
        subclass sets ``num_classes`` after ``Metric.__init__``."""
        if self.on_invalid == "ignore":
            return update

        @functools.wraps(update)
        def guarded(*args: Any, **kwargs: Any) -> None:
            args, kwargs, counters = guard_update_args(self, args, kwargs)
            self._faults = self._faults + FaultCounters(counters.counts.to(self._faults.counts.device))
            with value_checks_off():
                return update(*args, **kwargs)

        return guarded

    # ------------------------------------------------------------------
    # state registry
    # ------------------------------------------------------------------

    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Reduction = None,
        persistent: bool = False,
        template: Optional[Tensor] = None,
    ) -> None:
        """Register a named state: a tensor (fixed-shape accumulator), an
        empty list (a ``cat`` state, batches appended), a ``CatBuffer`` ring
        or a sketch state.

        ``template`` (list states only) is an empty ``(0, *row)`` tensor
        giving the rows' dtype and trailing shape: a sync gathers the list
        in that dtype, and a rank whose list is still empty gathers the
        template itself, so every rank issues the same collectives with the
        same dtype.
        """
        if isinstance(default, list):
            if default:
                raise ValueError("a list state's default must be an empty list")
        elif _is_tuple_state(default):
            default = _map_state(lambda t: t.to(self.device), default)
        elif isinstance(default, (Tensor, np.ndarray, int, float)):
            default = torch.as_tensor(default).to(self.device)
        else:
            raise ValueError("state variable must be a tensor, a sketch state or an empty list (any value)")
        if dist_reduce_fx not in ("sum", "mean", "cat", "max", "min", None) and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        if template is not None:
            if not isinstance(default, list):
                raise ValueError("`template` is only meaningful for list ('cat') states")
            self.__dict__.setdefault("_list_templates", {})[name] = torch.as_tensor(template).to(self.device)
        self._defaults[name] = default
        self._reductions[name] = dist_reduce_fx
        self._persistent[name] = persistent
        self._state[name] = _clone(default)

    # attribute routing so subclass code can write ``self.tp += x``
    def __setattr__(self, name: str, value: Any) -> None:
        defaults = self.__dict__.get("_defaults")
        if defaults is not None and name in defaults:
            self.__dict__["_state"][name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str) -> Any:
        # only called when normal lookup fails
        defaults = self.__dict__.get("_defaults")
        if defaults is not None and name in defaults:
            return self.__dict__["_state"][name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    @property
    def metric_state(self) -> Dict[str, Any]:
        """Copies of the current states: a held dict does not change when
        the metric updates (an update writes its states in place)."""
        return self._copy_state()

    @property
    def update_called(self) -> bool:
        return self._update_called

    @property
    def update_count(self) -> int:
        return self._update_count

    # ------------------------------------------------------------------
    # update / compute wrapping
    # ------------------------------------------------------------------

    def _to_device(self, x: Any) -> Any:
        if isinstance(x, Tensor):
            return x.to(self.device)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(self.device)
        return x

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            with _obs_trace.span("metric.update", metric=type(self).__name__):
                with self._state_swap_guard():
                    self._run_update(update, args, kwargs)
            if self.sync_mode == "overlapped" and not self._in_forward:
                self._notify_scheduler()

        return wrapped_func

    def _can_jit_update(self) -> bool:
        return self.jittable_update and not any(isinstance(d, list) for d in self._defaults.values())

    def _update_graph_table(self) -> Optional[UpdateGraphs]:
        """This metric's CUDA graphs (``_capture.py``), made at the first
        update that may capture; None where nothing is captured (the CPU,
        ``debug_checks``, an update that cannot be compiled, the updates
        inside ``forward`` or inside another metric's captured update)."""
        if self._in_forward or capturing() or self.compute_on_cpu or self.debug_checks or not self._can_jit_update():
            return None
        table = self.__dict__.get("_update_graphs")
        if table is None and self.device.type == "cuda":
            table = UpdateGraphs()
            object.__setattr__(self, "_update_graphs", table)
        return table

    def _drop_update_graphs(self) -> None:
        table = self.__dict__.get("_update_graphs")
        if table is not None:
            table.drop()

    def _run_update(self, update: Callable, args: tuple, kwargs: dict) -> None:
        self._computed = None
        self._update_count += 1
        self._update_called = True
        self._last_update_unix = time.time()
        if self._is_synced:
            raise MetricsTPUUserError(
                "The Metric shouldn't be synced when performing ``update``. HINT: Did you forget to call ``unsync``?"
            )
        args = tuple(self._to_device(a) for a in args)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        n_padded = 0
        if self.pad_batches:
            args, kwargs, n_padded = pad_update_args(self, args, kwargs)
        table = self._update_graph_table()
        # the wall tap: the host's time to launch the update (a replay, or
        # the eager update), only while tracing is on
        tap_t0 = time.perf_counter() if _obs_trace.tracing_enabled() and not capturing() else None
        if table is not None:
            table.run(self, update, args, kwargs)
        else:
            update(*args, **kwargs)
        if tap_t0 is not None:
            from metrics_tpu_torch.obs.runtime_metrics import observe_jit_wall
            from metrics_tpu_torch.ops.padding import leading_rows

            # per-tier histograms only for ladder tiers (pad_batches): raw
            # ragged sizes would mint one histogram per size
            rows = leading_rows(args) if self.pad_batches else None
            observe_jit_wall("metric_update_jit", rows, (time.perf_counter() - tap_t0) * 1e3)
        if self.debug_checks:
            self._check_finite_states()
        if n_padded:
            # the pad count is a shape difference, known on the host: one
            # add in place, outside any graph, without a copy that blocks
            idx = _IDX["padded_rows"]
            self._faults.counts[idx:idx + 1].add_(n_padded)
        if self.compute_on_cpu:
            self._move_list_states_to_host()

    def _check_finite_states(self) -> None:
        """``debug_checks``: fail when a float state (a tensor or a list's
        tensors) holds NaN or an infinity, with one read back. JAX's
        ``checkify.float_checks`` traps a NaN made by any operation of the
        update; this traps it in the states (stated difference D36)."""
        names, flags = [], []
        for name, value in self._state.items():
            for t in value if isinstance(value, list) else [value]:
                if isinstance(t, Tensor) and t.is_floating_point():
                    names.append(name)
                    flags.append(torch.isfinite(t).all())
        if not flags:
            return
        bad = sorted({n for n, ok in zip(names, torch.stack(flags).tolist()) if not ok})
        if bad:
            raise MetricsTPUUserError(
                f"{type(self).__name__}(debug_checks=True): the update left NaN or an infinity in "
                f"state(s) {bad}"
            )

    def _move_list_states_to_host(self) -> None:
        """``compute_on_cpu``: the list states' tensors move to host memory,
        in place in their lists (compute groups share the list objects)."""
        for value in self._state.values():
            if isinstance(value, list):
                value[:] = [v.cpu() for v in value]

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def traced_compute(*args: Any, **kwargs: Any) -> Any:
            # one span over the whole read path: cache hit, overlapped view
            # or blocking sync and compute (the sync also has its own span)
            with _obs_trace.span("metric.compute", metric=type(self).__name__):
                return wrapped_func(*args, **kwargs)

        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            # ``fresh=True``: the overlapped mode's way back to the blocking
            # sync (a no-op for a blocking metric)
            fresh = bool(kwargs.pop("fresh", False))
            if not self._update_called:
                rank_zero_warn(
                    f"The ``compute`` method of metric {type(self).__name__} was called before the ``update`` "
                    "method which may lead to errors, as metric states have not yet been updated.",
                    UserWarning,
                )
            if (
                self.sync_mode == "overlapped"
                and not fresh
                and self._to_sync
                and self.sync_on_compute
                and not self._is_synced
                # a batch value inside forward never reads the accumulated view
                and not self._in_forward
            ):
                value = self._overlapped_read(*args, **kwargs)
                if value is not _NO_SYNC_VIEW:
                    return value
                # no cycle has completed: ask for one, and sync now
                self._ensure_sync_scheduler().request()
            if self._computed is not None:
                return self._computed
            with self._state_swap_guard():
                with self.sync_context(dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync and self.sync_on_compute):
                    value = self._compute_unsynced(compute, *args, **kwargs)
                    # checked while synced: ``dropped`` and the fault counts
                    # are then global, so every rank takes the same branch
                    self._check_cat_overflow()
                    self._check_faults()
                self._computed = _squeeze_if_scalar(value)
            return self._computed

        return traced_compute

    def _compute_unsynced(self, compute: Callable, *args: Any, **kwargs: Any) -> Any:
        """``compute`` over the current state; with ``compute_on_cpu`` over
        host copies of every state, so the value lies on the CPU, while the
        metric's own states stay where they are for the next update."""
        if not self.compute_on_cpu:
            return compute(*args, **kwargs)
        state = self._state
        object.__setattr__(self, "_state", {k: _map_state(torch.Tensor.cpu, v) for k, v in state.items()})
        try:
            return compute(*args, **kwargs)
        finally:
            object.__setattr__(self, "_state", state)

    # ------------------------------------------------------------------
    # forward protocol
    # ------------------------------------------------------------------

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate into the global state AND return the batch's own value,
        kept in ``_forward_cache`` until the next ``reset``. The whole
        protocol holds the overlapped mode's lock and notifies the scheduler
        once, at its end, so a cycle never clones one of its passing states
        (a reset or a batch-only state)."""
        with self._state_swap_guard():
            object.__setattr__(self, "_in_forward", True)
            try:
                if self.full_state_update or self.dist_sync_on_step:
                    batch_val = self._forward_full_state_update(*args, **kwargs)
                else:
                    batch_val = self._forward_reduce_state_update(*args, **kwargs)
            finally:
                object.__setattr__(self, "_in_forward", False)
            self._forward_cache = batch_val
        if self.sync_mode == "overlapped":
            # one notify for the whole protocol, once the state is whole again
            self._notify_scheduler()
        return batch_val

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: one into the global state, one into a fresh state that
        gives the batch value (synced across processes with
        ``dist_sync_on_step``). The save and restore take in the child
        metrics (a wrapper's), so the second update never counts into a
        child's accumulated state."""
        self.update(*args, **kwargs)
        saved = self._deep_copy_state()
        self._to_sync = self.dist_sync_on_step
        self._deep_reset()
        self.update(*args, **kwargs)
        reported = self._faults_reported
        try:
            batch_val = self.compute()
        finally:
            # the accumulated state survives a compute that raises; the warn
            # watermark was the batch's own inside that compute
            self._deep_restore(saved)
            self._faults_reported = reported
            self._to_sync = True
            self._computed = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update on a fresh state, then a merge into the global state,
        the child metrics' included."""
        global_snap = self._deep_copy_state()
        self._deep_reset()
        self.update(*args, **kwargs)
        self._to_sync = False
        reported = self._faults_reported
        try:
            batch_val = self.compute()
        finally:
            # the batch is merged even when compute raises; the warn
            # watermark was the batch's own inside that compute
            self._faults_reported = reported
            self._deep_merge(global_snap)
            self._to_sync = True
            self._computed = None
        return batch_val

    def _child_metrics(self) -> Iterator["Metric"]:
        """The metrics held in an attribute or in an attribute's list or
        tuple (a wrapper's children), whose states the forward protocol
        saves, resets and merges with this metric's. A composition's
        operands are left out: its own ``forward`` drives them."""
        for _, child in self._named_child_metrics():
            yield child

    def _deep_copy_state(self) -> tuple:
        return self._copy_state(), self._update_count, [c._deep_copy_state() for c in self._child_metrics()]

    def _deep_restore(self, snapshot: tuple) -> None:
        state, count, children = snapshot
        object.__setattr__(self, "_state", state)
        self._update_count = count
        self._computed = None
        for c, cs in zip(self._child_metrics(), children):
            c._deep_restore(cs)

    def _deep_reset(self) -> None:
        self._restore_defaults()
        self._update_count = 0
        self._computed = None
        for c in self._child_metrics():
            c._deep_reset()

    def _deep_merge(self, global_snap: tuple) -> None:
        g_state, g_count, g_children = global_snap
        object.__setattr__(self, "_state", self._reduce_states(g_state, self._state, g_count))
        self._update_count = g_count + 1
        self._computed = None  # the cache holds the batch value
        for c, cs in zip(self._child_metrics(), g_children):
            c._deep_merge(cs)

    def _reduce_states(
        self,
        global_state: Dict[str, Any],
        batch_state: Dict[str, Any],
        global_count: int,
        batch_count: int = 1,
    ) -> Dict[str, Any]:
        """Merge a batch's states into the global ones, by reduction tag."""
        merged: Dict[str, Any] = {}
        for name, reduce_fn in self._reductions.items():
            g, b = global_state[name], batch_state[name]
            if _is_sketch_state(g):
                # a sketch merges by its own associative and commutative
                # union; the reduction tag is documentary
                merged[name] = g.sketch_merge(b)
            elif reduce_fn == "sum":
                merged[name] = g + b
            elif reduce_fn == "mean":
                if global_count == 0:
                    merged[name] = b
                else:
                    merged[name] = (g * global_count + b * batch_count) / (global_count + batch_count)
            elif reduce_fn == "max":
                merged[name] = torch.maximum(g, b)
            elif reduce_fn == "min":
                merged[name] = torch.minimum(g, b)
            elif isinstance(g, CatBuffer):
                # the batch ring's valid rows go into the global ring at its
                # capacity; rows past it drop and count, and the batch
                # ring's own drops carry over
                m = cat_append(g, b.data, valid=b.mask)
                merged[name] = m._replace(dropped=m.dropped + b.dropped)
            elif reduce_fn == "cat" or (reduce_fn is None and isinstance(g, list)):
                merged[name] = list(g) + list(b)
            elif callable(reduce_fn):
                merged[name] = reduce_fn(torch.stack([g, b]))
            else:
                raise MetricsTPUUserError(
                    f"State {name!r} has dist_reduce_fx={reduce_fn!r} which has no forward merge rule; "
                    f"set class attribute ``full_state_update = True`` for {type(self).__name__}."
                )
        return merged

    def _copy_state(self) -> Dict[str, Any]:
        return {k: _clone(v) for k, v in self._state.items()}

    def _restore_defaults(self) -> None:
        object.__setattr__(self, "_state", {k: _clone(v) for k, v in self._defaults.items()})

    # ------------------------------------------------------------------
    # abstract interface
    # ------------------------------------------------------------------

    def update(self, *args: Any, **kwargs: Any) -> None:  # pragma: no cover - abstract
        """Override to update state with batch data."""
        raise NotImplementedError

    @property
    def dropped_count(self) -> int:
        """Rows dropped by the ``CatBuffer`` rings: the largest count over
        rings that fill in lockstep (preds and target drop the same rows),
        the sum with ``_independent_ring_drops``. 0 when nothing overflowed
        or there is no ring. Reads the counts back from the device."""
        counts = [int(v.dropped) for v in self._state.values() if isinstance(v, CatBuffer)]
        return sum(counts) if self._independent_ring_drops else max(counts, default=0)

    def _check_cat_overflow(self) -> None:
        """Called by ``compute`` after the value is computed: when a ring
        dropped rows, warn or raise as ``on_overflow`` says. Overflow is
        never silent."""
        if self.on_overflow == "ignore":
            return
        n = self.dropped_count
        if not n:
            return
        msg = (
            f"{type(self).__name__}: {n} sample rows exceeded the configured `capacity` and were "
            "dropped; the computed value ignores them. Increase `capacity`, use the binned variant, "
            "or pass `on_overflow='ignore'` to silence this."
        )
        if self.on_overflow == "error":
            raise MetricsTPUUserError(msg)
        rank_zero_warn(msg, UserWarning)

    # ------------------------------------------------------------------
    # the fault channel
    # ------------------------------------------------------------------

    @property
    def fault_counts(self) -> Optional[Dict[str, int]]:
        """The fault channel's counts by class name
        (``utilities/guard.py::FAULT_CLASSES``), or None when the metric is
        unguarded (``on_invalid="ignore"``). Reads them back."""
        fc = self._state.get("_faults")
        return None if fc is None else fc.as_dict()

    def _check_faults(self) -> None:
        """The fault channel's boundary at ``compute()``: ``"warn"`` warns
        once for each new fault total and ``"error"`` raises until the state
        is reset, both from the synced counts plus the NaN states found now
        (``nonfinite_state``). ``"drop"`` has masked the rows already and
        stays silent; :attr:`fault_counts` shows what it masked."""
        if self.on_invalid in ("ignore", "drop"):
            return
        fc = self._state.get("_faults")
        if fc is None:
            return
        counts = fc.counts.cpu().numpy().astype(np.int64)
        counts[_IDX["nonfinite_state"]] += nan_state_leaves({k: v for k, v in self._state.items() if k != "_faults"})
        total = actionable_fault_total(counts)
        if self.on_invalid == "error":
            # no watermark: a poisoned accumulator raises until it is reset
            if total > 0:
                raise MetricsTPUUserError(format_fault_report(counts, type(self).__name__))
            return
        if total <= self._faults_reported:
            return
        self._faults_reported = total
        rank_zero_warn(format_fault_report(counts, type(self).__name__), UserWarning)

    def report_faults(self) -> None:
        """Apply the ``on_invalid`` policy to the current (ideally synced)
        counts now, for a caller that syncs without ``compute()``."""
        self._check_faults()

    # ------------------------------------------------------------------
    # the overlapped sync (parallel/async_sync.py)
    # ------------------------------------------------------------------

    def _notify_scheduler(self) -> None:
        """One update landed: tell the scheduler (which may snapshot now, on
        this thread)."""
        if self.device.type == "cuda":
            # the stream whose work the cycle's clone must follow
            object.__setattr__(self, "_update_stream", torch.cuda.current_stream(self.device))
        self._ensure_sync_scheduler().notify(steps=self._update_count)

    def _ensure_sync_scheduler(self):
        """This metric's scheduler, built on first use (a collection sets its
        own shared one on its members instead)."""
        sched = self.__dict__.get("_sync_scheduler")
        if sched is None:
            from metrics_tpu_torch.parallel.async_sync import AsyncSyncScheduler

            sched = AsyncSyncScheduler(
                snapshot_fn=self._overlap_snapshot,
                reduce_fn=self._overlap_reduce,
                sync_every_n=self.sync_every_n,
                sync_every_s=self.sync_every_s,
                on_error=_cycle_error_recorder(type(self).__name__),
                name=type(self).__name__,
            )
            object.__setattr__(self, "_sync_scheduler", sched)
        return sched

    def _overlap_snapshot(self):
        """A clone of the live state (a cycle's back buffer), made under the
        swap lock on the stream that ran the updates, with the event that
        follows it: ``((state, event), update count)``. The scheduler calls
        it at each trigger, on the triggering thread."""
        with self._state_swap_guard():
            stream = self.__dict__.get("_update_stream")
            with _on_stream(stream):
                state = self._copy_state()
                event = _record_event(state, stream)
            return (state, event), self._update_count

    def _cycle_stream(self) -> Optional[Any]:
        """The stream a cycle's collectives run on, its own (CUDA only)."""
        if self.device.type != "cuda":
            return None
        if self.__dict__.get("_side_stream") is None:
            object.__setattr__(self, "_side_stream", torch.cuda.Stream(self.device))
        return self._side_stream

    def _overlap_reduce(self, payload):
        """A cycle's sync, on the snapshot: the blocking path's
        :meth:`_synced_state` (an exact cycle's view is bit-equal to a
        blocking read of the batches it covers), or, with a quantized
        ``sync_transport`` (the argument, else
        ``METRICS_TPU_SYNC_TRANSPORT``, resolved each cycle), the host
        wire's rule. In a world of one process the view is the snapshot.
        Returns ``(state, event)``; the reader waits on the event."""
        state, event = payload
        if not distributed_available():
            return state, event
        side = self._cycle_stream()
        with _on_stream(side):
            _use_on_current_stream(state, event)
            synced = self._synced_state(state, self.dist_sync_fn, codec=resolve_codec(self.sync_transport))
            return synced, _record_event(synced, side)

    def _overlapped_read(self, *args: Any, **kwargs: Any) -> Any:
        """Compute from the scheduler's front view, with no collective;
        ``_NO_SYNC_VIEW`` before the first completed cycle."""
        sched = self.__dict__.get("_sync_scheduler")
        view = sched.view() if sched is not None else None
        if view is None:
            return _NO_SYNC_VIEW
        payload, event = view.payload
        key = self.__dict__.get("_sync_view_key")
        if key is not None:
            # a collection's view: each member's entry (state, covered steps)
            entry = payload.get(key)
            if entry is None:
                return _NO_SYNC_VIEW
            payload = entry[0]
        with self._state_swap_guard():
            _use_on_current_stream(payload, event)
            prev_state, prev_synced = self.__dict__["_state"], self._is_synced
            object.__setattr__(self, "_state", dict(payload))
            self._is_synced = True  # the view is the synced state
            try:
                value = self._original_compute(*args, **kwargs)
                self._check_cat_overflow()
                self._check_faults()
            finally:
                object.__setattr__(self, "_state", prev_state)
                self._is_synced = prev_synced
        return _squeeze_if_scalar(value)

    def request_sync(self, wait: bool = False, deadline_s: float = 30.0) -> bool:
        """Ask the overlapped scheduler for a cycle now. With ``wait=True``,
        block (at most ``deadline_s``) until the view covers every update so
        far; returns whether it does. A blocking metric returns True."""
        if self.sync_mode != "overlapped":
            return True
        sched = self._ensure_sync_scheduler()
        target = sched.seq()
        if not wait:
            sched.request()
            return sched.covered(target)
        return sched.wait_covered(target, deadline_s)

    @property
    def sync_lag(self) -> Optional[Dict[str, Any]]:
        """How far the overlapped view trails the live state
        (``sync_lag_steps``, ``sync_lag_s``); None for a blocking metric."""
        if self.sync_mode != "overlapped":
            return None
        sched = self.__dict__.get("_sync_scheduler")
        if sched is None:
            return {"sync_lag_steps": self._update_count, "sync_lag_s": None, "synced_once": False, "in_flight": False}
        key = self.__dict__.get("_sync_view_key")
        if key is None:
            return sched.lag(live_steps=self._update_count)
        # a collection's view: this member's own entry
        base = sched.lag(live_steps=self._update_count)
        view = sched.view()
        entry = view.payload[0].get(key) if view is not None else None
        if entry is None:
            return {**base, "sync_lag_steps": self._update_count, "sync_lag_s": None, "synced_once": False}
        return {**base, "sync_lag_steps": max(0, self._update_count - entry[1])}

    # ------------------------------------------------------------------
    # multi-process sync
    # ------------------------------------------------------------------

    def _sync_defaults(self) -> Dict[str, Any]:
        """The list states' templates, which the sync gathers in their place
        when a list is empty."""
        return dict(self.__dict__.get("_list_templates", {}))

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        """Sync every state across processes with one exact
        :func:`~metrics_tpu_torch.parallel.sync.fused_sync`."""
        with _obs_trace.span("metric.sync_dist", metric=type(self).__name__):
            object.__setattr__(self, "_state", self._synced_state(self._state, dist_sync_fn, process_group))

    def _synced_state(
        self,
        state: Dict[str, Any],
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        codec: Any = None,
    ) -> Dict[str, Any]:
        """``state`` synced across processes; reads only the metric's
        configuration, so an overlapped cycle runs it on a clone. ``codec``
        is the overlapped cycle's host wire; without it the sync is exact."""
        group = self.process_group if process_group is None else process_group
        (synced,) = fused_sync(
            [self._state_for_sync(state)],
            [self._reductions],
            group,
            [self._sync_defaults()],
            comm=dist_sync_fn,
            transport="exact",
            host_codec=codec,
        )
        return synced

    def _state_for_sync(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """``state`` as a sync sends it: with ``compute_on_cpu`` the host
        list states go back to the metric's device (an NCCL group gathers
        CUDA tensors only)."""
        if not self.compute_on_cpu:
            return state
        return {k: [t.to(self.device) for t in v] if isinstance(v, list) else v for k, v in state.items()}

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available_fn: Optional[Callable] = None,
    ) -> None:
        """Keep the local state aside and replace it with the synced one."""
        if self._is_synced and should_sync:
            raise MetricsTPUUserError("The Metric has already been synced.")
        is_distributed = (distributed_available_fn or distributed_available)()
        if not should_sync or not is_distributed:
            return
        # the sync builds new state values and mutates none, so the local
        # state is kept as it is, without a copy
        self._cache = dict(self._state)
        self._sync_dist(dist_sync_fn, process_group=process_group)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local state kept by :meth:`sync`."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsTPUUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsTPUUserError("The internal cache should exist to unsync the Metric.")
        object.__setattr__(self, "_state", self._cache)
        self._is_synced = False
        self._cache = None

    @contextlib.contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available_fn: Optional[Callable] = None,
    ) -> Iterator[None]:
        """Synced inside the block, local again after it (even when the
        block raises)."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available_fn=distributed_available_fn,
        )
        try:
            yield
        finally:
            if self._is_synced and should_unsync:
                self.unsync()

    def compute(self) -> Any:  # pragma: no cover - abstract
        """Override to compute the final value from state."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # reset / clone / persistence
    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Restore the default state. An overlapped metric's view covers the
        old stream: its scheduler stops, and the next update starts another."""
        sched = self.__dict__.get("_sync_scheduler")
        if sched is not None and self.__dict__.get("_sync_view_key") is None:
            sched.stop(final=False, timeout_s=5.0)
        object.__setattr__(self, "_sync_scheduler", None)
        self._update_count = 0
        self._update_called = False
        self._last_update_unix = None
        self._computed = None
        self._forward_cache = None
        self._cache = None
        self._is_synced = False
        # the counts restart with the state, and so does the warn watermark
        self._faults_reported = 0
        # new state tensors: the graphs that wrote into the old ones go
        self._drop_update_graphs()
        self._restore_defaults()

    def clone(self) -> "Metric":
        return deepcopy(self)

    def persistent(self, mode: bool = False) -> None:
        """Set the persistence flag of every state."""
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, prefix: str = "") -> Dict[str, Any]:
        """Copies of the persistent states: tensors, lists of tensors, a ring
        as a ``{"data", "mask", "dropped"}`` mapping, a sketch state as its
        ``to_primitives()`` mapping, and the fault counters as their counts
        vector."""
        out: Dict[str, Any] = {}
        for key in self._defaults:
            if self._persistent[key]:
                value = self._state[key]
                if _is_sketch_state(value):
                    out[prefix + key] = value.to_primitives()
                elif isinstance(value, CatBuffer):
                    out[prefix + key] = dict(_clone(value)._asdict())
                elif isinstance(value, FaultCounters):
                    out[prefix + key] = value.counts.clone()
                else:
                    out[prefix + key] = _clone(value)
        return out

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "") -> None:
        """Restore states saved by :meth:`state_dict`.

        Every value is checked against the registered default's shape and
        dtype before any state changes: a mismatched checkpoint raises a
        ``ValueError`` naming the state and leaves the metric untouched.
        The metric keeps copies: a tensor in ``state_dict`` is never shared
        with it, so two metrics loaded from one dict stay independent.
        """
        loaded = {
            key: self._validated_state_value(key, state_dict[prefix + key])
            for key in self._defaults
            if prefix + key in state_dict
        }
        self._check_ring_capacity_consistency("load_state_dict", {**self._state, **loaded})
        if loaded:
            self._drop_update_graphs()
            self._state.update(loaded)
            self._update_called = True
            self._computed = None

    def _check_ring_capacity_consistency(self, via: str, state: Dict[str, Any]) -> None:
        """Rings that fill in lockstep pair their rows by position, so they
        must share one capacity; checked before anything is loaded."""
        if self._independent_ring_drops:
            return
        caps = {key: v.capacity for key, v in state.items() if isinstance(v, CatBuffer)}
        if len(set(caps.values())) > 1:
            raise ValueError(
                f"{type(self).__name__}.{via}: lockstep ring states loaded at different "
                f"capacities ({caps}); their rows pair positionally, so a partial or mismatched load "
                "would silently misalign them. Load all rings of this metric at one capacity."
            )

    def _validated_state_value(self, key: str, v: Any, via: str = "load_state_dict") -> Any:
        """One loaded value, checked against ``self._defaults[key]``, as a
        copy on the metric's device in the default's dtype; ``via`` names
        the entry point in the error."""
        default = self._defaults[key]

        def fail(why: str) -> None:
            raise ValueError(
                f"{type(self).__name__}.{via}: state {key!r} {why}; refusing to load a corrupt checkpoint."
            )

        def as_tensor(value: Any) -> Tensor:
            if not isinstance(value, Tensor):
                arr = np.asarray(value)
                if arr.dtype == object:
                    fail(f"is not a numeric array (got {type(value).__name__})")
                value = torch.tensor(arr)
            return value

        def as_leaf(value: Any, like: Tensor, part: str, free_leading: bool = False) -> Tensor:
            value = as_tensor(value)
            # a ring may load at another capacity (a synced union, a restore
            # at another world size); its row shape is fixed
            want = tuple(like.shape[1:]) if free_leading else tuple(like.shape)
            got = tuple(value.shape[1:]) if free_leading else tuple(value.shape)
            if got != want or (free_leading and value.ndim != like.ndim):
                fail(f"{part}has shape {tuple(value.shape)}, expected {tuple(like.shape)}" + (" (any capacity)" if free_leading else ""))
            if not torch.can_cast(value.dtype, like.dtype):
                fail(f"{part}has dtype {value.dtype}, incompatible with expected {like.dtype}")
            return value.to(device=self.device, dtype=like.dtype, copy=True)

        if isinstance(default, FaultCounters):
            counts = getattr(v, "counts", v)  # the port's or the JAX package's counters, or their vector
            arr = np.asarray(counts.cpu() if isinstance(counts, Tensor) else counts).reshape(-1)
            if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer) or bool((arr < 0).any()):
                fail("is a FaultCounters state and must load from a vector of non-negative integer counts")
            # the classes are appends-only: a shorter vector pads the newer
            # classes with zeros, a longer one keeps the classes known here
            arr = np.concatenate([arr.astype(np.int64), np.zeros(max(0, NUM_FAULT_CLASSES - arr.shape[0]), np.int64)])
            return FaultCounters(torch.from_numpy(arr[:NUM_FAULT_CLASSES].copy()).to(self.device))
        if _is_sketch_state(default):
            try:
                return type(default).from_primitives(v, like=default)
            except ValueError as err:
                fail(f"failed sketch-state validation: {err}")
        if isinstance(default, CatBuffer):
            if isinstance(v, CatBuffer):
                v = v._asdict()
            if not isinstance(v, dict) or not {"data", "mask"} <= set(v):
                fail(
                    "is a CatBuffer ring state and must load from a {'data', 'mask', 'dropped'} "
                    f"mapping (got {type(v).__name__})"
                )
            data = as_leaf(v["data"], default.data, "slot 'data' ", free_leading=True)
            mask = as_leaf(v["mask"], default.mask, "slot 'mask' ", free_leading=True)
            if mask.shape[0] != data.shape[0]:
                fail(f"has mask length {mask.shape[0]} != data capacity {data.shape[0]}")
            dropped = v.get("dropped")
            dropped = default.dropped.clone() if dropped is None else as_leaf(dropped, default.dropped, "slot 'dropped' ")
            return CatBuffer(data, mask, dropped)
        if isinstance(default, list):
            if not isinstance(v, (list, tuple)):
                fail(f"is a list ('cat') state and must load from a list (got {type(v).__name__})")
            return [as_tensor(x).to(self.device, copy=True) for x in v]
        value = as_tensor(v)
        if tuple(value.shape) != tuple(default.shape):
            fail(f"has shape {tuple(value.shape)}, expected {tuple(default.shape)}")
        if not torch.can_cast(value.dtype, default.dtype):
            fail(f"has dtype {value.dtype}, incompatible with expected {default.dtype}")
        return value.to(device=self.device, dtype=default.dtype, copy=True)

    # ------------------------------------------------------------------
    # crash-recovery snapshots
    # ------------------------------------------------------------------

    @staticmethod
    def _serialize_state_value(current: Any) -> Any:
        """One state as plain numpy data, as the JAX package writes it: a
        list of arrays, a ring as a ``{"data", "mask", "dropped"}`` dict,
        the fault counters as their counts vector, a sketch state as its
        ``to_primitives()`` mapping."""

        def host(t: Tensor) -> np.ndarray:
            # a copy: the numpy view of a CPU tensor would share the live
            # state, which updates write in place
            return t.detach().to("cpu", copy=True).numpy()

        if isinstance(current, list):
            return [host(x) for x in current]
        if isinstance(current, CatBuffer):
            return {"data": host(current.data), "mask": host(current.mask), "dropped": host(current.dropped)}
        if isinstance(current, FaultCounters):
            return host(current.counts)
        if _is_sketch_state(current):
            return {k: host(v) for k, v in current.to_primitives().items()}
        return host(current)

    def _named_child_metrics(self) -> Iterator[Any]:
        """``(name, child)`` for every metric held in an attribute or in an
        attribute's list or tuple (a wrapped metric, a composition's
        operands): the tree a snapshot covers."""
        for key, v in self.__dict__.items():
            if isinstance(v, Metric):
                yield key, v
            elif isinstance(v, (list, tuple)):
                for i, x in enumerate(v):
                    if isinstance(x, Metric):
                        yield f"{key}[{i}]", x

    def snapshot_state(self) -> Dict[str, Any]:
        """Every state (persistence flags ignored), the update count, the
        time of the last update, the attributes an update inferred
        (``_snapshot_attrs``) and, recursively, the child metrics' own
        snapshots, as plain data. An overlapped metric snapshots under its
        swap lock, so the state is never one that a cycle is swapping."""
        with self._state_swap_guard():
            out: Dict[str, Any] = {
                "states": {key: self._serialize_state_value(self._state[key]) for key in self._defaults},
                "update_count": self._update_count,
            }
            if self._last_update_unix is not None:
                out["last_update_unix"] = self._last_update_unix
            attrs = {name: getattr(self, name) for name in self._snapshot_attrs if getattr(self, name, None) is not None}
            if attrs:
                out["attrs"] = attrs
            children = {name: child.snapshot_state() for name, child in self._named_child_metrics()}
            if children:
                out["children"] = children
            return out

    def load_snapshot_state(self, payload: Dict[str, Any]) -> None:
        """Restore a :meth:`snapshot_state` payload, this package's or the
        JAX package's. Every state of the whole tree is validated (as
        :meth:`load_state_dict` validates) before anything is committed: a
        payload with an unknown state, attribute or child, or a value of the
        wrong shape or dtype, raises and leaves every metric untouched."""
        self._commit_snapshot_state(self._prepare_snapshot_state(payload))

    def _prepare_snapshot_state(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """The validating half of :meth:`load_snapshot_state`: changes
        nothing and returns what :meth:`_commit_snapshot_state` applies."""
        name = type(self).__name__
        states = payload.get("states", {})
        unknown = [key for key in states if key not in self._defaults]
        if unknown:
            raise ValueError(
                f"{name}.load_snapshot_state: snapshot carries unknown state {unknown[0]!r}; "
                "refusing to load (metric config mismatch?)"
            )
        loaded = {key: self._validated_state_value(key, value, via="load_snapshot_state") for key, value in states.items()}
        self._check_ring_capacity_consistency("load_snapshot_state", {**self._state, **loaded})
        attrs = {}
        for attr, value in payload.get("attrs", {}).items():
            if attr not in self._snapshot_attrs:
                raise ValueError(
                    f"{name}.load_snapshot_state: snapshot carries data-inferred attribute {attr!r} "
                    "this class does not declare in `_snapshot_attrs`"
                )
            attrs[attr] = _own_enum(value)
        mine = dict(self._named_child_metrics())
        children = {}
        for child_name, child_payload in payload.get("children", {}).items():
            if child_name not in mine:
                raise ValueError(
                    f"{name}.load_snapshot_state: snapshot carries child metric {child_name!r} "
                    "this instance does not have; refusing to load"
                )
            children[child_name] = (mine[child_name], mine[child_name]._prepare_snapshot_state(child_payload))
        return {
            "loaded": loaded,
            "update_count": int(payload.get("update_count", self._update_count)),
            "last_update_unix": payload.get("last_update_unix"),
            "attrs": attrs,
            "children": children,
        }

    def _commit_snapshot_state(self, prepared: Dict[str, Any]) -> None:
        self._drop_update_graphs()
        self._state.update(prepared["loaded"])
        self._update_count = prepared["update_count"]
        self._update_called = self._update_count > 0
        if prepared["last_update_unix"] is not None:
            self._last_update_unix = prepared["last_update_unix"]
        elif self._update_count > 0 and self._last_update_unix is None:
            # a fed metric from a snapshot without the clock: "restored now"
            self._last_update_unix = time.time()
        self._computed = None
        self._is_synced = False
        self._cache = None
        for attr, value in prepared["attrs"].items():
            current = getattr(self, attr, None)
            if current is not None and current != value:
                rank_zero_warn(
                    f"{type(self).__name__}.load_snapshot_state: overriding {attr}={current!r} with the "
                    f"snapshot's {value!r} (the restored states were accumulated under it)",
                    UserWarning,
                )
            setattr(self, attr, value)
        for child, child_prepared in prepared["children"].values():
            child._commit_snapshot_state(child_prepared)

    def __getstate__(self) -> Dict[str, Any]:
        # no scheduler thread, lock or stream travels: the copy builds its
        # own on first use
        return {k: v for k, v in self.__dict__.items() if k not in _PER_INSTANCE}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self.__dict__.setdefault("sync_mode", "blocking")
        self.__dict__.setdefault("_last_update_unix", None)
        self.__dict__.setdefault("compute_on_cpu", False)
        self.__dict__.setdefault("dist_sync_on_step", False)
        self.__dict__.setdefault("sync_on_compute", True)
        self.__dict__.setdefault("debug_checks", False)
        self._init_overlap()
        self._wrap_methods()

    def __deepcopy__(self, memo: dict) -> "Metric":
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k not in _PER_INSTANCE:
                object.__setattr__(new, k, deepcopy(v, memo))
        new._init_overlap()
        new._wrap_methods()
        return new

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # dtype, identity and arithmetic
    # ------------------------------------------------------------------

    def type(self, *_: Any, **__: Any) -> "Metric":
        """A no-op, as ``float``, ``double`` and ``half`` are: the states
        keep their dtypes (:meth:`set_dtype` casts them)."""
        return self

    float = double = half = type

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast every floating state, its default and a list state's
        template to ``dst_type``; integer states keep their dtypes."""

        def cast(t: Tensor) -> Tensor:
            return t.to(dst_type) if t.is_floating_point() else t

        object.__setattr__(self, "_state", {k: _map_state(cast, v) for k, v in self._state.items()})
        object.__setattr__(self, "_defaults", {k: _map_state(cast, v) for k, v in self._defaults.items()})
        templates = self.__dict__.get("_list_templates")
        if templates:
            self.__dict__["_list_templates"] = {k: cast(v) for k, v in templates.items()}
        self._computed = None
        return self

    # ``==`` builds a composition, so the hash is the identity's, which no
    # update or reset changes (stated difference D22)
    __hash__ = object.__hash__

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.truediv, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.truediv, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.floordiv, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.floordiv, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mod, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mod, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.and_, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.and_, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.or_, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.or_, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(operator.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(operator.ne, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.ge, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.gt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.le, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.lt, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep the kwargs that the update signature takes."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        filtered_kwargs = {
            k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)
        }
        if any(v.kind == inspect.Parameter.VAR_KEYWORD for v in _sign_params.values()):
            filtered_kwargs = kwargs
        return filtered_kwargs

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"



def _own_enum(value: Any) -> Any:
    """A snapshot attribute as this package holds it: an enum of the JAX
    package (an input mode) becomes the enum of the same name and value
    here."""
    if isinstance(value, Enum) and not isinstance(value, enums.EnumStr):
        own = getattr(enums, type(value).__name__, None)
        if own is not None:
            return own(value.value)
    return value


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


class CompositionalMetric(Metric):
    """The lazy composition of metrics with an operator (counterpart of the
    JAX package's ``CompositionalMetric``): ``update``, ``reset`` and
    ``persistent`` go to the operands, and ``compute`` combines their
    values. It holds no state of its own and no compute cache; the device
    is its first metric operand's.

    Outside a collection each operand syncs itself at its own ``compute()``,
    as in the JAX package. Inside a ``MetricCollection`` the operands'
    states ride the collection's one sync instead (stated difference D23).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision, Recall
        >>> p = Precision(num_classes=3, average="macro", device="cpu")
        >>> r = Recall(num_classes=3, average="macro", device="cpu")
        >>> f1 = 2 * p * r / (p + r)
        >>> f1.update(torch.tensor([0, 2, 1, 1]), torch.tensor([0, 1, 1, 2]))
        >>> round(float(f1.compute()), 4)
        0.5
    """

    jittable_update = False
    jittable_compute = False

    def __init__(self, operator: Callable, metric_a: Any, metric_b: Any) -> None:
        operands = [m for m in (metric_a, metric_b) if isinstance(m, Metric)]
        super().__init__(device=operands[0].device if operands else None)
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)

    def _operand(self, value: Any) -> Any:
        """A metric, a Python number (kept as it is, so that it takes part
        in type promotion as a scalar) or an array as a tensor here."""
        if value is None or isinstance(value, (Metric, bool, int, float)):
            return value
        return torch.as_tensor(value, device=self.device)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # the operands sync themselves

    def _child_metrics(self) -> Iterator[Metric]:
        return iter(())  # the composition's own forward drives its operands

    def _wrap_compute(self, compute: Callable) -> Callable:
        # no cache here: each operand caches its own value, and a cached
        # composition would outlive a reset of its operands
        return compute

    def operand_leaves(self) -> list:
        """Every metric under this composition that holds states, each once,
        in the order of the tree."""
        out: list = []
        for m in (self.metric_a, self.metric_b):
            if isinstance(m, CompositionalMetric):
                leaves = m.operand_leaves()
            elif isinstance(m, Metric):
                leaves = [m]
            else:
                leaves = []
            out.extend(x for x in leaves if not any(x is y for y in out))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    @property
    def _update_called(self) -> bool:
        a = self.metric_a._update_called if isinstance(self.metric_a, Metric) else True
        b = self.metric_b._update_called if isinstance(self.metric_b, Metric) else True
        return a and b

    @_update_called.setter
    def _update_called(self, value: bool) -> None:
        pass  # the operands own the flag

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            return None
        if val_b is None:
            if isinstance(self.metric_b, Metric):
                return None
            return self.op(val_a)
        return self.op(val_a, val_b)

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        op = getattr(self.op, "__name__", self.op)
        return f"{type(self).__name__}(\n  {op}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"
