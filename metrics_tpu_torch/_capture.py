"""The compiled update (counterpart of ``metrics_tpu/metric.py:394``).

One CUDA-graph capture of a metric's update per key: the counterpart of
``_make_update_jit`` and of the jit branch of ``_run_update``
(``metrics_tpu/metric.py:481-513``).

The JAX package jits a metric's update; its counterpart on the card is
capture: the update's launches are recorded once into a
``torch.cuda.CUDAGraph`` and replayed, with no Python on the way. It is not
code generation: the graph replays the same kernels (the port's own among
them) that the eager update launches.

:class:`UpdateGraphs` is one metric's table of graphs. Its key is the
update's arguments (shapes, dtypes and devices: with ``pad_batches`` a
ladder tier), the data-inferred attributes (``_snapshot_attrs``) and the
identity of the state tensors the graphs write into.

- The first update at a key runs eagerly, value checks included: it
  resolves the data-inferred attributes and loads the kernel libraries.
- The next update at that key captures the body as the guard wraps it,
  under :func:`~metrics_tpu_torch.utilities.checks.value_checks_off`, as
  JAX's traced update runs; the capture runs nothing, so the graph is then
  replayed once for this update. Every later update at the key replays it,
  after copying its arguments into the graph's static input buffers.
- An update that rebinds a state to a new tensor (the fault counters, a
  ring's ``dropped``, the out-of-place sums) is followed by a copy of the
  new value into the tensor the graph was captured against, inside the
  graph, and the binding is restored; the eager update at a new key does
  the same, so the states keep their identity across updates.
- A new identity (``reset``, ``load_state_dict``, a ``forward``'s merge, a
  clone) drops the table: its graphs wrote into dead tensors. ``sync`` and
  ``unsync`` hand the same tensors back, and the graphs stay.
- A capture that fails (a read back inside the body, an operation that a
  capture does not allow, a state that changed its shape) turns
  ``jittable_update`` off on the instance and runs the update eagerly, as
  JAX's runtime does after a failed trace (``metrics_tpu/metric.py:494``).

A wrapper's launch count (``ops/_build.py::count_launch``) is taken by its
Python code, which a replay does not run: the launches of a capture are
recorded and added again at every replay.

The capture step is a function the table is given (:func:`cuda_graph_capture`
on the card); the CPU tests give it one that runs the body eagerly.
"""
import contextlib
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.utilities.checks import value_checks_off

Tensor = torch.Tensor
Capture = Callable[[Callable[[], None], Any], Callable[[], None]]

_local = threading.local()


def capturing() -> bool:
    """True inside a captured body (or :func:`eager_updates`) on this thread:
    an update nested in it (a wrapped metric's) runs as it is."""
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def eager_updates() -> Iterator[None]:
    """Every update on this thread runs eagerly inside the block."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def _side_stream(device: torch.device) -> Any:
    """This thread's capture stream on ``device``."""
    streams = _local.__dict__.setdefault("streams", {})
    stream = streams.get(device)
    if stream is None:
        stream = streams[device] = torch.cuda.Stream(device)
    return stream


def cuda_graph_capture(run: Callable[[], None], pool: Any) -> Callable[[], None]:
    """Capture ``run`` into a CUDA graph in ``pool`` (a graph pool handle)
    on this thread's side stream, and return its ``replay``.
    ``thread_local`` mode: another thread's allocations and
    synchronizations during the capture (a serving worker's) do not
    invalidate it."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream()
    side = _side_stream(current.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            run()
        finally:
            graph.capture_end()
    current.wait_stream(side)
    return graph.replay


def _value_leaves(value: Any) -> Tuple[Tensor, ...]:
    """The tensors of one state: a tensor, or a NamedTuple of tensors (a
    ring, the fault counters, a sketch state)."""
    if isinstance(value, Tensor):
        return (value,)
    return tuple(v for v in value if isinstance(v, Tensor))


def _leaf_key(value: Any) -> Optional[tuple]:
    """One argument as part of a key: a tensor by shape, dtype and device, a
    Python scalar or None by its value; None when the argument cannot key a
    graph."""
    if isinstance(value, Tensor):
        return ("t", tuple(value.shape), value.dtype, value.device)
    if value is None or isinstance(value, (bool, int, float, str)):
        return ("py", type(value), value)
    return None


def _arg_key(args: tuple, kwargs: dict) -> Optional[tuple]:
    parts = [_leaf_key(a) for a in args] + [_leaf_key(kwargs[k]) for k in sorted(kwargs)]
    if any(p is None for p in parts):
        return None
    return tuple(parts), tuple(sorted(kwargs))


def _attr_key(metric: Any) -> Optional[tuple]:
    attrs = tuple((a, getattr(metric, a, None)) for a in metric._snapshot_attrs)
    try:
        hash(attrs)
    except TypeError:
        return None
    return attrs


def _tensors(args: tuple, kwargs: dict) -> List[Tensor]:
    """The argument tensors in key order."""
    return [a for a in args if isinstance(a, Tensor)] + [kwargs[k] for k in sorted(kwargs) if isinstance(kwargs[k], Tensor)]


class CaptureRefused(RuntimeError):
    """The body cannot be captured as it is (a state changed its shape)."""


class _Entry:
    __slots__ = ("replay", "inputs", "launches")

    def __init__(self, replay: Callable[[], None], inputs: List[Tensor], launches: Dict[tuple, int]) -> None:
        self.replay = replay
        self.inputs = inputs
        self.launches = launches


class UpdateGraphs:
    """One metric's graphs, by key; see the module's docstring.

    ``capture(run, pool)`` records ``run`` and returns a function that
    replays it; it must not execute ``run``'s work (the table replays once
    after a capture). ``pool`` is the metric's one graph memory pool, shared
    by its graphs, which never replay at the same time (None on the CPU);
    when a new identity drops the graphs the pool goes with them, and the
    next capture takes a new one (PyTorch refuses a pool whose graphs are
    all gone). Counters: ``captures``, ``capture_s`` (the host's
    seconds in captures), ``replays``, ``eager_updates`` and ``dropped``
    (graphs dropped with a state identity)."""

    def __init__(self, capture: Capture = cuda_graph_capture) -> None:
        self.capture = capture
        self.entries: Dict[tuple, _Entry] = {}
        self.seen: set = set()
        self.pool: Any = None
        self.bound_values: Dict[str, Any] = {}
        self.bound: Tuple[Tuple[Tensor, ...], ...] = ()
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.eager_updates = 0
        self.dropped = 0
        self.error: Optional[str] = None

    # -- the states' identity ------------------------------------------

    def _check_identity(self, state: Dict[str, Any]) -> None:
        """Drop every graph when the states are no longer the tensors they
        were captured against."""
        leaves = tuple(_value_leaves(v) for v in state.values())
        if len(leaves) == len(self.bound) and all(
            len(a) == len(b) and all(x is y for x, y in zip(a, b)) for a, b in zip(leaves, self.bound)
        ):
            return
        self._clear()
        self.bound_values = dict(state)
        self.bound = leaves

    def _clear(self) -> None:
        """Drop every graph, and with them their pool."""
        self.dropped += len(self.entries)
        self.entries.clear()
        self.seen.clear()
        self.pool = None

    def drop(self) -> None:
        """Forget every graph and the states they write into."""
        self._clear()
        self.bound_values = {}
        self.bound = ()

    def _write_back(self, state: Dict[str, Any]) -> bool:
        """Copy every rebound state into the tensor it replaced and restore
        the binding; False (nothing changed) when a state's layout changed."""
        pairs = []
        for name, old in self.bound_values.items():
            new = state.get(name)
            if new is old:
                continue
            old_leaves, new_leaves = _value_leaves(old), _value_leaves(new) if new is not None else ()
            if type(old) is not type(new) or len(old_leaves) != len(new_leaves) or any(
                o.shape != n.shape or o.dtype != n.dtype or o.device != n.device for o, n in zip(old_leaves, new_leaves)
            ):
                return False
            pairs.append((name, old, old_leaves, new_leaves))
        for name, old, old_leaves, new_leaves in pairs:
            for o, n in zip(old_leaves, new_leaves):
                if o is not n:
                    o.copy_(n)
            state[name] = old
        return True

    # -- updates ---------------------------------------------------------

    def run(self, metric: Any, update: Callable, args: tuple, kwargs: dict) -> None:
        """One update of ``metric`` through the table."""
        state = metric._state
        self._check_identity(state)
        arg_key, attrs = _arg_key(args, kwargs), _attr_key(metric)
        key = None if arg_key is None or attrs is None else (arg_key, attrs)
        entry = self.entries.get(key) if key is not None else None
        if entry is not None:
            for dst, src in zip(entry.inputs, _tensors(args, kwargs)):
                dst.copy_(src)
            self._launch(entry)
            return
        if key is None or key not in self.seen:
            self._eager(metric, update, args, kwargs)
            attrs = _attr_key(metric)
            if arg_key is not None and attrs is not None:
                self.seen.add((arg_key, attrs))
            return
        if self._capture(metric, update, key, args, kwargs):
            self._launch(self.entries[key])
        else:
            self._eager(metric, update, args, kwargs)

    def prepare(self, metric: Any, update: Callable, args: tuple, kwargs: dict) -> bool:
        """Capture the graph of ``args`` without running it (a warmup's
        step); True when a graph for their key exists afterwards."""
        self._check_identity(metric._state)
        arg_key, attrs = _arg_key(args, kwargs), _attr_key(metric)
        if arg_key is None or attrs is None:
            return False
        key = (arg_key, attrs)
        return key in self.entries or self._capture(metric, update, key, args, kwargs)

    def _eager(self, metric: Any, update: Callable, args: tuple, kwargs: dict) -> None:
        self.eager_updates += 1
        update(*args, **kwargs)
        state = metric._state
        if not self._write_back(state):
            self._check_identity(state)

    def _launch(self, entry: _Entry) -> None:
        entry.replay()
        for (module, counter), n in entry.launches.items():
            _build.count_launch(module, counter, n)
        self.replays += 1

    def _capture(self, metric: Any, update: Callable, key: tuple, args: tuple, kwargs: dict) -> bool:
        """Capture the body at ``key`` into a new entry; on failure turn the
        instance's ``jittable_update`` off and return False."""
        inputs: List[Tensor] = []

        def static(value: Any) -> Any:
            if isinstance(value, Tensor):
                buf = value.clone()
                inputs.append(buf)
                return buf
            return value

        s_args = tuple(static(a) for a in args)
        s_kwargs = {k: static(kwargs[k]) for k in sorted(kwargs)}
        state = metric._state

        def body() -> None:
            with eager_updates(), value_checks_off():
                update(*s_args, **s_kwargs)
            if not self._write_back(state):
                raise CaptureRefused(f"{type(metric).__name__}.update changes the layout of a state")

        if self.pool is None and metric.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        with _build.record_launches() as rec:
            try:
                replay = self.capture(body, self.pool)
            except Exception as err:  # noqa: BLE001 - any failure to capture means the eager update
                failure = err
            else:
                failure = None
        self.capture_s += time.perf_counter() - t0
        # the capture launched nothing on the card
        for (module, counter), n in rec.launches.items():
            _build.count_launch(module, counter, -n)
        if failure is not None:
            state.update(self.bound_values)
            object.__setattr__(metric, "jittable_update", False)
            self.error = f"{type(failure).__name__}: {failure}"
            return False
        self.entries[key] = _Entry(replay, inputs, dict(rec.launches))
        self.captures += 1
        return True
