"""Pure functions over explicit states (counterpart of ``metrics_tpu/pure.py``).

A metric, a trace-safe wrapper or a collection becomes a set of functions
over a state that the caller holds::

    mdef = functionalize(Accuracy(num_classes=10, device="cuda"))
    state = mdef.init()
    state = mdef.update(state, preds, target)
    value = mdef.compute(state)

The metric serves as a template: its update and compute bodies run with the
given state swapped in, under the metric's swap lock, and its own state,
update count, sync flag and compute cache are put back afterwards.

Purity. The port's updates write their states in place (``self.tp += tp``,
``cat_append`` into a ring), so ``update`` swaps in a copy of the state it
is given and returns the copy's tensors: the given state never changes, and
two states that share an ancestor stay apart (``merge``, ``overlapped``'s
``live`` and ``reduced``). The JAX package's jitted update can donate its
input instead (stated difference D28); the copy costs one pass over the
state's bytes per update. ``merge`` and ``cycle`` build new tensors too.

Differences from the JAX package, each stated in ROADMAP Queue 3:

- ``group=`` takes the place of ``axis_name`` (D26): ``None`` means no sync,
  a process group (``torch.distributed.group.WORLD``) a sync over it through
  :func:`~metrics_tpu_torch.parallel.sync.fused_sync` and its default
  communicator. ``dropped`` and ``faults`` then sum over the group in one
  ``all_reduce``.
- A collection's ``update`` runs every member's update (D27). The JAX
  package's jitted graph shares the work of members with equal updates
  (XLA's common-subexpression elimination); the eager port runs them all,
  with the same values.
- ``bootstrap_functionalize`` draws from a ``torch.Generator`` (D29), and
  keeps the draw apart from the vmapped update
  (``bdef.update.with_indices``). With ``group`` it syncs the replicas'
  stacked state in one ``fused_sync`` over the replica axis (D26), every
  state kind that JAX's batched sync takes: rings, quantile sketches and
  callable reductions replica by replica.
- A metric is refused by its declared ``jittable_update`` and
  ``jittable_compute`` flags only (D30): the port compiles nothing, so no
  failed trace turns a flag off.

- ``sliced_functionalize(..., shard_slices=group)`` reduce-scatters the
  slice rings over the group (``torch.distributed.reduce_scatter`` through
  the default communicator, bounded like every other collective), where
  JAX's ``psum_scatter`` runs over a mesh axis (D31).
"""
import contextlib
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric, _is_sketch_state
from metrics_tpu_torch.ops.padding import SLICE_STATE_PREFIX
from metrics_tpu_torch.ops.quantize import validate_transport
from metrics_tpu_torch.parallel.sync import DEGRADED, _default_transport, fused_sync, resolve_sync_chunks
from metrics_tpu_torch.sliced.slicing import SlicedMetric
from metrics_tpu_torch.utilities.checks import value_checks_off
from metrics_tpu_torch.utilities.data import _flatten_dict, apply_to_collection
from metrics_tpu_torch.utilities.guard import NUM_FAULT_CLASSES, FaultCounters, can_drop_traced
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_concat
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper

Tensor = torch.Tensor

# the attributes of a template that an update or a compute moves, saved and
# put back around every swap
_SWAPPED_ATTRS = ("_update_count", "_update_called", "_to_sync", "_computed", "_faults_reported", "_last_update_unix")


class MetricDef(NamedTuple):
    """Pure functions over an explicit state.

    ``dropped(state)`` is the number of rows the state's ``CatBuffer`` rings
    dropped, an int32 tensor (0 without rings); ``faults(state)`` the
    fault channel's ``(NUM_FAULT_CLASSES,)`` counts, int64 (zeros for an
    unguarded metric), summed over the members of a wrapper or a
    collection. With ``group`` both sum over the group's processes.
    """

    init: Callable[[], Any]
    update: Callable[..., Any]
    compute: Callable[[Any], Any]
    merge: Callable[..., Any]
    dropped: Optional[Callable[[Any], Tensor]] = None
    faults: Optional[Callable[[Any], Tensor]] = None

    def entry_points(self) -> Dict[str, Callable]:
        """The entry points a warmup would compile, by name, as the JAX
        package names them: ``update`` takes ``(state, *batch)``,
        ``compute`` takes ``(state,)``. The pure update is not captured
        yet: it copies its state (D28) and runs every member (D27)."""
        return {"update": self.update, "compute": self.compute}


def _owned_tree(state: Any) -> Any:
    """A copy of every tensor of ``state`` (nested dicts, lists and
    NamedTuples), for a body that writes in place."""
    return apply_to_collection(state, Tensor, torch.Tensor.clone)


@contextlib.contextmanager
def _swapped(metrics: List[Metric], states: List[Dict[str, Any]]) -> Iterator[None]:
    """Each metric's state replaced by the given one inside the block, with
    its sync flag off (a state given explicitly is synced already, or meant
    to stay local) and no compute cache; everything put back afterwards,
    under each metric's swap lock."""
    with contextlib.ExitStack() as stack:
        for m in metrics:
            stack.enter_context(m._state_swap_guard())
        saved = [(m.__dict__["_state"], [getattr(m, a) for a in _SWAPPED_ATTRS]) for m in metrics]
        try:
            for m, s in zip(metrics, states):
                object.__setattr__(m, "_state", dict(s))
                m._computed = None
                m._to_sync = False
                m._update_called = True  # no "compute before update" warning
            yield
        finally:
            for m, (state, values) in zip(metrics, saved):
                object.__setattr__(m, "_state", state)
                for a, v in zip(_SWAPPED_ATTRS, values):
                    setattr(m, a, v)


def _device_of(metric: Any) -> torch.device:
    if isinstance(metric, MetricCollection):
        return next(iter(metric.values(copy_state=False))).device
    return metric.device


def _on_device(metric: Metric, args: tuple, kwargs: dict) -> tuple:
    return tuple(metric._to_device(a) for a in args), {k: metric._to_device(v) for k, v in kwargs.items()}


def _sum_over(group: Optional[Any], value: Tensor) -> Tensor:
    """``value`` summed over the group's processes (one ``all_reduce``);
    itself without a group."""
    if group is None:
        return value
    return fused_sync([{"v": value}], [{"v": "sum"}], group)[0]["v"]


def _dropped_in_state(state: Dict[str, Any], device: torch.device, independent: bool = False) -> Tensor:
    """Rows dropped by one metric's rings: the largest count for lockstep
    rings, the sum for ``_independent_ring_drops``."""
    total = torch.zeros((), dtype=torch.int32, device=device)
    for v in state.values():
        if isinstance(v, CatBuffer):
            d = v.dropped.to(torch.int32)
            total = total + d if independent else torch.maximum(total, d)
    return total


def _faults_in_state(state: Dict[str, Any], device: torch.device) -> Tensor:
    """The metric's fault counts, zeros when it is unguarded. A
    ``SlicedMetric`` without counters of its own keeps its wrapped metric's
    counts in the ``sl___faults`` ring: every row of it, the quarantine and
    the discard included."""
    fc = state.get("_faults")
    if isinstance(fc, FaultCounters):
        return fc.counts
    ring = state.get(f"{SLICE_STATE_PREFIX}_faults")
    if ring is not None:
        return ring.sum(dim=0)
    return torch.zeros((NUM_FAULT_CLASSES,), dtype=torch.int64, device=device)


def _check_drop_traceable(metric: Metric) -> None:
    """``on_invalid="drop"`` must not boolean-index (a read back) here."""
    if getattr(metric, "on_invalid", "ignore") == "drop" and not can_drop_traced(metric):
        raise ValueError(
            f"{type(metric).__name__} cannot apply on_invalid='drop' in the pure layer: its update has no "
            "row-weight machinery (capacity-mode `valid` masks or aggregator NaN masking). Construct it with "
            "capacity=N, or use on_invalid='warn'/'error' (the counters accumulate, the policy acts at compute)."
        )


def _has_list_state(metric: Metric) -> bool:
    return any(isinstance(d, list) for d in metric._defaults.values())


def functionalize(metric: Any, group: Optional[Any] = None) -> MetricDef:
    """Pure ``init/update/compute/merge/dropped/faults`` of a metric, a
    trace-safe wrapper (a list of per-node states, the wrapper first and its
    children depth first) or a collection (a dict of its members' states by
    name; ``compute`` returns the named values, prefix and postfix
    applied). With ``group``, ``compute`` syncs the state over the group
    first, one ``fused_sync`` (a collection's members in one, each wrapper
    in its own).

    Refused, as in the JAX package: a metric with unbounded list (``cat``)
    states (construct it with ``capacity=N``), a ``BootStrapper`` (see
    :func:`bootstrap_functionalize`), a metric that declares
    ``jittable_update`` or ``jittable_compute`` False, and
    ``on_invalid="drop"`` on a metric that would boolean-index.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> mdef = functionalize(Accuracy(num_classes=3, device="cpu"))
        >>> state = mdef.update(mdef.init(), torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1]]), torch.tensor([0, 2]))
        >>> round(float(mdef.compute(state)), 4)
        0.5
    """
    if isinstance(metric, MetricCollection):
        return _functionalize_collection(metric, group)
    if not isinstance(metric, Metric):
        raise TypeError(
            f"functionalize expects a Metric or MetricCollection, got {type(metric).__name__}. "
            "(MetricTracker is bookkeeping over copies: functionalize the tracked metric itself and keep "
            "per-epoch states yourself.)"
        )
    if isinstance(metric, BootStrapper):
        raise ValueError(
            "BootStrapper's copy loop cannot run as pure functions; use bootstrap_functionalize(base_metric, "
            "num_bootstraps), the vmapped form of the same resampling."
        )
    if _is_trace_safe_wrapper(metric):
        return _functionalize_wrapper(metric, group)
    if _has_list_state(metric):
        raise ValueError(
            f"{type(metric).__name__} has unbounded list ('cat') states and cannot be functionalized; "
            "construct it with capacity=N (CatBuffer ring state) or use its binned variant."
        )
    if not metric.jittable_update or not metric.jittable_compute:
        raise ValueError(
            f"{type(metric).__name__} is not trace-safe (jittable_update/compute is False): its update or "
            "compute needs concrete values. For aggregators, construct with nan_strategy='ignore' or a float."
        )
    _check_drop_traceable(metric)
    reductions = dict(metric._reductions)
    defaults = metric._sync_defaults()
    device = metric.device

    def init() -> Dict[str, Any]:
        return _owned_tree(metric._defaults)

    def update(state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        args, kwargs = _on_device(metric, args, kwargs)
        with _swapped([metric], [_owned_tree(state)]):
            metric._original_update(*args, **kwargs)
            return dict(metric.__dict__["_state"])

    def compute(state: Dict[str, Any]) -> Any:
        if group is not None:
            state = fused_sync([state], [reductions], group, [defaults])[0]
        with _swapped([metric], [state]):
            return metric._original_compute()

    has_mean_state = any(fx == "mean" for fx in reductions.values())

    def merge(state_a: Dict[str, Any], state_b: Dict[str, Any], count_a: Optional[float] = None, count_b: Optional[float] = None) -> Dict[str, Any]:
        """Combine two accumulated states. A ``"mean"`` state needs the
        number of updates folded into each side (``count_a``/``count_b``)."""
        if has_mean_state and (count_a is None or count_b is None):
            raise ValueError(
                f"{type(metric).__name__} has 'mean'-reduced state; merge() needs count_a/count_b "
                "(the number of updates folded into each side) to combine correctly."
            )
        return _merge_by_reduction(reductions, state_a, state_b, count_a, count_b, type(metric).__name__)

    def dropped(state: Dict[str, Any]) -> Tensor:
        return _sum_over(group, _dropped_in_state(state, device, metric._independent_ring_drops))

    def faults(state: Dict[str, Any]) -> Tensor:
        return _sum_over(group, _faults_in_state(state, device))

    return MetricDef(init=init, update=update, compute=compute, merge=merge, dropped=dropped, faults=faults)


def _stack(values: List[Any]) -> Any:
    """Per-replica outputs (tensors, or dicts or lists of them) stacked
    along a new leading axis."""
    first = values[0]
    if isinstance(first, dict):
        return {k: _stack([v[k] for v in values]) for k in first}
    if isinstance(first, (list, tuple)) and not hasattr(first, "_fields"):
        return type(first)(_stack([v[i] for v in values]) for i in range(len(first)))
    if hasattr(first, "_fields"):  # a NamedTuple state: field by field
        return type(first)(*(_stack([v[i] for v in values]) for i in range(len(first))))
    return torch.stack([torch.as_tensor(v) for v in values])


def _replica(state: Any, i: int) -> Any:
    return apply_to_collection(state, Tensor, lambda t: t[i])


def bootstrap_functionalize(metric: Metric, num_bootstraps: int = 10, group: Optional[Any] = None) -> MetricDef:
    """``num_bootstraps`` resampled replicas of a metric as one set of pure
    functions over a stacked state (a leading replica axis), with one
    ``torch.func.vmap``-ped update.

    Resampling is multinomial (each replica draws ``n`` rows of the
    ``n``-row batch with replacement). ``update(state, generator, *args,
    **kwargs)`` draws the ``(num_bootstraps, n)`` indices from the
    ``torch.Generator`` (on its device), then calls
    ``update.with_indices(state, indices, *args, **kwargs)``, which a
    caller may call with indices drawn elsewhere. Positional arguments are
    resampled along their leading axis; keyword arguments pass as they are.
    The vmapped update runs without the value checks (they read values
    back, which ``vmap`` cannot), as the JAX package's traced update does;
    the refusals of :func:`functionalize` apply. A metric whose update
    launches a kernel (the Binned metrics' K1, the confusion family's K2, a
    ``QuantileSketch``'s K3 cascade) runs on the card too: the replicas are
    the lanes of one launch of the kernel's lane-batched form
    (``ops/_build.py::lane_route``), as ``pallas_call``'s batching rule
    batches the JAX package's kernels.

    ``compute`` returns ``{"mean", "std" (ddof=1), "raw"}``; integer values
    (a confusion matrix) are averaged in float32. With ``group``
    it syncs the stacked state in one ``fused_sync`` over a replica axis
    (``lanes=num_bootstraps``: the collectives of one replica's sync,
    whatever the number of replicas), then computes each replica, with the
    value JAX's ``jax.vmap(mdef.compute)`` gives it: each replica's ring
    the union of its own rows, its quantile sketch the fold of its own
    sketches (K3's lane-batched merge cascade on the card), a callable
    reduction over its own ``(rank, ...)`` rows. ``dropped`` and
    ``faults`` sum every replica's counts in one ``all_reduce``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> bdef = bootstrap_functionalize(Accuracy(num_classes=3, device="cpu"), 20)
        >>> preds, target = torch.tensor([0, 1, 2, 2]), torch.tensor([0, 1, 2, 1])
        >>> state = bdef.update(bdef.init(), torch.Generator().manual_seed(0), preds, target)
        >>> sorted(bdef.compute(state))
        ['mean', 'raw', 'std']
    """
    if not (isinstance(num_bootstraps, int) and num_bootstraps > 1):
        raise ValueError("Expected argument `num_bootstraps` to be an integer larger than 1")
    mdef = functionalize(metric)  # each replica's own functions, local
    sync = None if group is None else _fused_sync_tree(metric, group, lanes=num_bootstraps)

    def init() -> Any:
        return apply_to_collection(mdef.init(), Tensor, lambda t: torch.stack([t] * num_bootstraps))

    def update_with_indices(state: Any, indices: Tensor, *args: Any, **kwargs: Any) -> Any:
        if not args:
            raise ValueError("bootstrap update needs at least one positional (batch) argument")
        args, kwargs = _on_device(metric, args, kwargs)
        n = args[0].shape[0]
        for pos, a in enumerate(args[1:], 1):
            if a.shape[0] != n:
                raise ValueError(f"bootstrap update arg {pos} has leading dim {a.shape[0]}, expected {n}")
        indices = torch.as_tensor(indices, device=args[0].device)
        if tuple(indices.shape) != (num_bootstraps, n):
            raise ValueError(f"bootstrap indices have shape {tuple(indices.shape)}, expected {(num_bootstraps, n)}")

        def one(st: Any, idx: Tensor) -> Any:
            return mdef.update(st, *(a[idx] for a in args), **kwargs)

        with value_checks_off():
            return torch.func.vmap(one)(state, indices)

    def update(state: Any, generator: torch.Generator, *args: Any, **kwargs: Any) -> Any:
        if not args:
            raise ValueError("bootstrap update needs at least one positional (batch) argument")
        n = len(args[0])
        indices = torch.randint(0, n, (num_bootstraps, n), generator=generator, device=generator.device)
        return update_with_indices(state, indices, *args, **kwargs)

    update.with_indices = update_with_indices  # type: ignore[attr-defined]

    def compute(state: Any) -> Dict[str, Any]:
        if sync is not None:
            state = sync(state)
        raw = _stack([mdef.compute(_replica(state, i)) for i in range(num_bootstraps)])
        # integer values (a confusion matrix) average in float32, as jnp's mean and std do
        real = apply_to_collection(raw, Tensor, lambda v: v if v.is_floating_point() else v.to(torch.float32))
        mean = apply_to_collection(real, Tensor, lambda v: v.mean(dim=0))
        std = apply_to_collection(real, Tensor, lambda v: v.std(dim=0, correction=1))
        return {"mean": mean, "std": std, "raw": raw}

    def merge(state_a: Any, state_b: Any, **counts: Any) -> Any:
        return _stack([mdef.merge(_replica(state_a, i), _replica(state_b, i), **counts) for i in range(num_bootstraps)])

    def dropped(state: Any) -> Tensor:
        # the replicas resample one batch stream: the worst replica
        per_replica = torch.stack([mdef.dropped(_replica(state, i)) for i in range(num_bootstraps)])
        return _sum_over(group, per_replica).max()

    def faults(state: Any) -> Tensor:
        per_replica = torch.stack([mdef.faults(_replica(state, i)) for i in range(num_bootstraps)])
        return _sum_over(group, per_replica).amax(dim=0)

    return MetricDef(init=init, update=update, compute=compute, merge=merge, dropped=dropped, faults=faults)


class OverlappedDef(NamedTuple):
    """Pure functions for an overlapped (double-buffered) sync, over the
    state ``{"live": <the local accumulator>, "reduced": <the last synced
    copy>, "steps": int32, "covered": int32}``:

    - ``update(state, *batch)`` folds a batch into ``live`` only, with no
      collective;
    - ``cycle(state)`` syncs a copy of ``live`` (one ``fused_sync`` over
      every member of the whole tree) and publishes it as ``reduced``;
    - ``read(state)`` computes from ``reduced`` with no collective: at most
      one cycle stale;
    - ``read_fresh(state)`` syncs ``live`` now (always the exact
      transport) and computes: the blocking read;
    - ``lag(state)`` is ``steps - covered``;
    - ``faults``/``dropped`` read ``reduced``, which a cycle has summed.

    ``read`` after ``cycle`` equals ``read_fresh`` over the batches the
    cycle covered, bit for bit with the exact transport.
    """

    init: Callable[[], Dict[str, Any]]
    update: Callable[..., Dict[str, Any]]
    cycle: Callable[[Dict[str, Any]], Dict[str, Any]]
    read: Callable[[Dict[str, Any]], Any]
    read_fresh: Callable[[Dict[str, Any]], Any]
    lag: Callable[[Dict[str, Any]], Tensor]
    faults: Optional[Callable[[Dict[str, Any]], Tensor]] = None
    dropped: Optional[Callable[[Dict[str, Any]], Tensor]] = None

    def entry_points(self) -> Dict[str, Callable]:
        """The entry points by name, as the JAX package names them:
        ``update`` takes ``(state, *batch)``; ``cycle``, ``read``,
        ``read_fresh`` and ``lag`` take ``(state,)``."""
        return {
            "update": self.update,
            "cycle": self.cycle,
            "read": self.read,
            "read_fresh": self.read_fresh,
            "lag": self.lag,
        }


def _fused_sync_tree(
    metric: Any, group: Any, transport: Optional[str] = None, chunks: Optional[int] = None,
    lanes: Optional[int] = None,
) -> Callable[[Any], Any]:
    """``state -> synced state`` as one ``fused_sync`` over every node of a
    metric, a trace-safe wrapper or a collection (its wrappers' nodes
    included); ``lanes`` for a state stacked on a leading replica axis."""
    if isinstance(metric, MetricCollection):
        members = list(metric.items(keep_base=True, copy_state=False))
        wrapper_names = {name for name, m in members if _is_trace_safe_wrapper(m)}
        rows = []  # (name, node index or None, node)
        for name, m in members:
            if name in wrapper_names:
                rows.extend((name, j, node) for j, node in enumerate(_collect_metrics(m)))
            else:
                rows.append((name, None, m))
    elif _is_trace_safe_wrapper(metric):
        rows = [(None, j, node) for j, node in enumerate(_collect_metrics(metric))]
    else:
        rows = [(None, None, metric)]
    reductions = [dict(node._reductions) for _, _, node in rows]
    defaults = [node._sync_defaults() for _, _, node in rows]

    def pick(state: Any, name: Optional[str], j: Optional[int]) -> Dict[str, Any]:
        s = state if name is None else state[name]
        return s if j is None else s[j]

    def sync_tree(state: Any) -> Any:
        synced = fused_sync(
            [pick(state, name, j) for name, j, _ in rows], reductions, group, defaults,
            transport=transport, chunks=chunks, lanes=lanes,
        )
        if not isinstance(metric, MetricCollection):
            return synced if _is_trace_safe_wrapper(metric) else synced[0]
        out = {name: (list(s) if isinstance(s, list) else s) for name, s in state.items()}
        for (name, j, _), s in zip(rows, synced):
            if j is None:
                out[name] = s
            else:
                out[name][j] = s
        return out

    return sync_tree


def overlapped_functionalize(
    metric: Any,
    group: Optional[Any] = None,
    sync_transport: Optional[str] = None,
    sync_chunks: Optional[int] = None,
) -> OverlappedDef:
    """The overlapped pure functions of a metric, wrapper or collection (see
    :class:`OverlappedDef`). Without ``group`` a cycle publishes a copy of
    ``live``, so the layout is the same in one process and in many.
    ``sync_transport`` (``"exact"``, ``"fp16"``, ``"int8"``; ``None``
    resolves ``METRICS_TPU_SYNC_TRANSPORT``) is the wire of the cycle's
    float sum leaves; ``sync_chunks`` splits each bucket into that many
    collectives (bit-equal). Both are validated here.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> odef = overlapped_functionalize(Accuracy(num_classes=3, device="cpu"))
        >>> s = odef.update(odef.init(), torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        >>> s = odef.cycle(s)
        >>> round(float(odef.read(s)), 4), int(odef.lag(s))
        (0.6667, 0)
    """
    validate_transport(sync_transport)
    if sync_chunks is not None:
        resolve_sync_chunks(sync_chunks)  # a bad count raises here
    mdef = functionalize(metric)  # local update, local compute
    if group is None:
        sync_tree, sync_tree_fresh = _owned_tree, (lambda s: s)
    else:
        sync_tree = _fused_sync_tree(metric, group, transport=sync_transport, chunks=sync_chunks)
        # the blocking read is exact, whatever the cycle ships
        sync_tree_fresh = _fused_sync_tree(metric, group, transport="exact", chunks=sync_chunks)
    device = _device_of(metric)

    def init() -> Dict[str, Any]:
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return {"live": mdef.init(), "reduced": mdef.init(), "steps": zero, "covered": zero.clone()}

    def update(state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return {**state, "live": mdef.update(state["live"], *args, **kwargs), "steps": state["steps"] + 1}

    def cycle(state: Dict[str, Any]) -> Dict[str, Any]:
        return {**state, "reduced": sync_tree(state["live"]), "covered": state["steps"].clone()}

    def read(state: Dict[str, Any]) -> Any:
        return mdef.compute(state["reduced"])

    def read_fresh(state: Dict[str, Any]) -> Any:
        return mdef.compute(sync_tree_fresh(state["live"]))

    def lag(state: Dict[str, Any]) -> Tensor:
        return state["steps"] - state["covered"]

    def faults(state: Dict[str, Any]) -> Tensor:
        return mdef.faults(state["reduced"])

    def dropped(state: Dict[str, Any]) -> Tensor:
        return mdef.dropped(state["reduced"])

    return OverlappedDef(init=init, update=update, cycle=cycle, read=read, read_fresh=read_fresh, lag=lag, faults=faults, dropped=dropped)


def sliced_functionalize(
    metric: Any,
    num_slices: int,
    group: Optional[Any] = None,
    shard_slices: Optional[Any] = None,
) -> MetricDef:
    """Per-cohort pure functions: ``metric`` (or every member of a
    collection) wrapped in :class:`~metrics_tpu_torch.SlicedMetric` and
    functionalized, so ``update(state, *batch, slice_ids=ids)`` folds all
    ``num_slices`` slices at once and ``compute`` returns per-slice values
    and the rollup. The rings are plain sum, max and min states: with
    ``group`` they ride ``fused_sync``'s buckets.

    **Sharded slices** (``shard_slices=<process group>``): each of the
    group's ``S`` processes owns ``K / S`` slices, rank ``r`` the slices
    ``r * K / S`` on. ``update`` keeps the full local rings; ``compute``
    sums the rollup's slice-summed states in one ``all_reduce`` (one more
    for float states), reduce-scatters each sum ring (the row counts first)
    so that each process holds its own slices summed over the group, and
    reduces max and min rings whole (one ``all_reduce`` per operation and
    dtype). It returns ``{"per_slice": <values of the owned slices>,
    "slice_offset", "slice_rows", "global_value", "quarantined_rows"}``.
    A single metric only; ``K`` must divide over ``S``; ``group`` must be
    omitted (the slice shard is the data group, and ``S`` is its size).
    A collective that degrades leaves this process's own values.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> mdef = sliced_functionalize(SumMetric(device="cpu"), num_slices=2)
        >>> state = mdef.update(mdef.init(), torch.tensor([1.0, 2.0, 4.0]), slice_ids=torch.tensor([0, 1, 1]))
        >>> [float(v) for v in mdef.compute(state).per_slice]
        [1.0, 6.0]
    """
    if isinstance(metric, SlicedMetric):
        wrapped: Any = metric
    elif isinstance(metric, MetricCollection):
        if shard_slices is not None:
            raise ValueError(
                "sliced_functionalize(shard_slices=...) shards a single metric's slice "
                "axis; shard each collection member separately."
            )
        wrapped = MetricCollection({
            name: m if isinstance(m, SlicedMetric) else SlicedMetric(m, num_slices=num_slices)
            for name, m in metric.items(keep_base=True, copy_state=False)
        })
    else:
        wrapped = SlicedMetric(metric, num_slices=num_slices)

    if shard_slices is None:
        return functionalize(wrapped, group=group)
    if group is not None:
        raise ValueError(
            "sliced_functionalize: pass `shard_slices` alone — the slice shard IS the data group."
        )
    count = torch.distributed.get_world_size(shard_slices)
    if wrapped.num_slices % count:
        raise ValueError(
            f"num_slices ({wrapped.num_slices}) must divide evenly over "
            f"the group's {count} processes so every one owns the same slice quota"
        )
    return _sliced_sharded_def(wrapped, shard_slices, count)


def _sliced_sharded_def(w: SlicedMetric, group: Any, count: int) -> MetricDef:
    """The sharded-slice ``compute`` over a ``SlicedMetric``'s state (see
    :func:`sliced_functionalize`)."""
    mdef = functionalize(w)  # local update and merge; state = [wrapper, child]
    K, kloc = w.num_slices, w.num_slices // count
    specs = dict(w._specs)
    sum_kinds = ("sum", "mean", "faults", "sketch_sum")

    def scatter_sum(x: Tensor, rank: int) -> Tensor:
        """This process's ``kloc`` rows of ``x`` summed over the group."""
        parts = [p.contiguous() for p in x.chunk(count, dim=0)]
        out = torch.empty_like(parts[rank])
        if _default_transport().reduce_scatter(out, parts, group=group) is DEGRADED:
            return parts[rank].clone()
        return out

    def compute(states: List[Dict[str, Any]]) -> Dict[str, Any]:
        wstate = dict(states[0])
        rank = torch.distributed.get_rank(group)
        rows_full = wstate[f"{SLICE_STATE_PREFIX}rows"]
        rows_body = rows_full[:K]
        # the rollup: one all_reduce of the slice-summed states, the
        # integer ones carried as int64 (exact) so they share one bucket
        tree: Dict[str, Tensor] = {"rows_tail": rows_full[K:], "rows_total": rows_body.sum().reshape(1)}
        for name, kind in specs.items():
            if kind in sum_kinds:
                tree[name] = wstate[f"{SLICE_STATE_PREFIX}{name}"][:K].sum(dim=0)
        dtypes = {k: v.dtype for k, v in tree.items()}
        wide = {k: v if v.is_floating_point() else v.to(torch.int64) for k, v in tree.items()}
        summed = fused_sync([wide], [{k: "sum" for k in wide}], group)[0]
        tree = {k: v.to(dtypes[k]) for k, v in summed.items()}

        rows_owned = scatter_sum(rows_body, rank)
        total = torch.clamp_min(tree["rows_total"][0], 1).to(torch.float32)
        raw_owned: Dict[str, Tensor] = {}
        raw_roll: Dict[str, Tensor] = {}
        for name, kind in specs.items():
            if kind not in sum_kinds:
                continue
            owned = scatter_sum(wstate[f"{SLICE_STATE_PREFIX}{name}"][:K], rank)
            if kind == "mean":
                denom = torch.clamp_min(rows_owned, 1).to(torch.float32)
                raw_owned[name] = owned / denom.reshape((kloc,) + (1,) * (owned.ndim - 1))
                raw_roll[name] = tree[name] / total
            else:
                raw_owned[name] = owned
                raw_roll[name] = tree[name]
        extremes = {name: wstate[f"{SLICE_STATE_PREFIX}{name}"][:K] for name, kind in specs.items() if kind not in sum_kinds}
        if extremes:
            reds = {name: "max" if specs[name] in ("max", "sketch_max") else "min" for name in extremes}
            whole = fused_sync([extremes], [reds], group)[0]
            for name, g in whole.items():
                raw_owned[name] = g[rank * kloc:(rank + 1) * kloc]
                raw_roll[name] = g.amax(dim=0) if reds[name] == "max" else g.amin(dim=0)
        return {
            "per_slice": w._per_slice_values(raw_owned),
            "slice_offset": torch.tensor(rank * kloc, dtype=torch.int32, device=rows_full.device),
            "slice_rows": rows_owned,
            "global_value": w._run_raw(raw_roll),
            "quarantined_rows": tree["rows_tail"][0],
        }

    def dropped(states: List[Dict[str, Any]]) -> Tensor:
        return _sum_over(group, mdef.dropped(states))

    def faults(states: List[Dict[str, Any]]) -> Tensor:
        return _sum_over(group, mdef.faults(states))

    return MetricDef(init=mdef.init, update=mdef.update, compute=compute, merge=mdef.merge, dropped=dropped, faults=faults)


def _merge_by_reduction(
    reductions: Dict[str, Any],
    state_a: Dict[str, Any],
    state_b: Dict[str, Any],
    count_a: Optional[float],
    count_b: Optional[float],
    owner_name: str,
) -> Dict[str, Any]:
    """Two states combined by each state's reduction tag, into new tensors."""
    merged: Dict[str, Any] = {}
    for name, fx in reductions.items():
        a, b = state_a[name], state_b[name]
        if _is_sketch_state(a):
            merged[name] = a.sketch_merge(b)
        elif isinstance(a, CatBuffer):
            merged[name] = cat_concat(a, b)
        elif fx == "sum":
            merged[name] = a + b
        elif fx == "mean":
            if count_a is None or count_b is None:
                raise ValueError(
                    f"{owner_name} has 'mean'-reduced state; merge() needs count_a/count_b "
                    "(the number of updates folded into each side) to combine correctly."
                )
            merged[name] = (a * count_a + b * count_b) / (count_a + count_b)
        elif fx == "max":
            merged[name] = torch.maximum(a, b)
        elif fx == "min":
            merged[name] = torch.minimum(a, b)
        elif callable(fx):
            merged[name] = fx(torch.stack([a, b]))
        else:
            raise ValueError(f"State {name!r} with reduction {fx!r} has no pure merge rule.")
    return merged


def _is_trace_safe_wrapper(metric: Metric) -> bool:
    """A wrapper whose body only delegates to its children
    (``_wrapper_trace_safe``)."""
    return bool(list(metric._child_metrics())) and getattr(metric, "_wrapper_trace_safe", False)


def _collect_metrics(metric: Metric) -> List[Metric]:
    """A wrapper's tree of metrics, itself first, depth first."""
    out = [metric]
    for child in metric._child_metrics():
        out.extend(_collect_metrics(child))
    return out


def _functionalize_wrapper(wrapper: Metric, group: Optional[Any] = None) -> MetricDef:
    """Pure functions of a trace-safe wrapper over a list of per-node states
    (the wrapper first, its children depth first): ``update`` and
    ``compute`` swap every node's state in and run the wrapper's own body."""
    metrics = _collect_metrics(wrapper)
    for m in metrics:
        _check_drop_traceable(m)
    for m in metrics:
        if _has_list_state(m):
            raise ValueError(
                f"{type(m).__name__} (inside {type(wrapper).__name__}) has unbounded list ('cat') "
                "states; construct it with capacity=N to functionalize the wrapper."
            )
        if m is not wrapper and not _is_trace_safe_wrapper(m) and not (m.jittable_update and m.jittable_compute):
            raise ValueError(
                f"{type(m).__name__} (inside {type(wrapper).__name__}) is not trace-safe; the "
                "wrapper cannot be functionalized around it."
            )
    reductions = [dict(m._reductions) for m in metrics]
    defaults = [m._sync_defaults() for m in metrics]
    device = wrapper.device

    def init() -> List[Dict[str, Any]]:
        return [_owned_tree(m._defaults) for m in metrics]

    def update(states: List[Dict[str, Any]], *args: Any, **kwargs: Any) -> List[Dict[str, Any]]:
        args, kwargs = _on_device(wrapper, args, kwargs)
        with _swapped(metrics, _owned_tree(states)):
            wrapper._original_update(*args, **kwargs)
            return [dict(m.__dict__["_state"]) for m in metrics]

    def compute(states: List[Dict[str, Any]]) -> Any:
        if group is not None:
            states = fused_sync(states, reductions, group, defaults)
        with _swapped(metrics, states):
            return wrapper._original_compute()

    def merge(states_a: List[Dict[str, Any]], states_b: List[Dict[str, Any]], count_a: Optional[float] = None, count_b: Optional[float] = None) -> List[Dict[str, Any]]:
        return [
            _merge_by_reduction(r, a, b, count_a, count_b, type(m).__name__)
            for m, r, a, b in zip(metrics, reductions, states_a, states_b)
        ]

    def dropped(states: List[Dict[str, Any]]) -> Tensor:
        total = torch.zeros((), dtype=torch.int32, device=device)
        for m, s in zip(metrics, states):  # distinct metrics drop independently
            total = total + _dropped_in_state(s, device, m._independent_ring_drops)
        return _sum_over(group, total)

    def faults(states: List[Dict[str, Any]]) -> Tensor:
        return _sum_over(group, sum(_faults_in_state(s, device) for s in states))

    return MetricDef(init=init, update=update, compute=compute, merge=merge, dropped=dropped, faults=faults)


def _functionalize_collection(collection: MetricCollection, group: Optional[Any] = None) -> MetricDef:
    """Pure functions over a ``{member name: state}`` dict. A trace-safe
    wrapper member keeps its list of node states and syncs in its own
    ``compute``; the other members sync in one ``fused_sync``."""
    members = list(collection.items(keep_base=True, copy_state=False))
    wrapper_names = {name for name, m in members if _is_trace_safe_wrapper(m)}
    mdefs = {
        name: (_functionalize_wrapper(m, group) if name in wrapper_names else functionalize(m))
        for name, m in members
    }
    fused = [(name, m) for name, m in members if name not in wrapper_names]
    device = _device_of(collection)

    def init() -> Dict[str, Any]:
        return {name: mdefs[name].init() for name, _ in members}

    def update(state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return {name: mdefs[name].update(state[name], *args, **m._filter_kwargs(**kwargs)) for name, m in members}

    def compute(state: Dict[str, Any]) -> Dict[str, Any]:
        if group is not None and fused:
            synced = fused_sync(
                [state[name] for name, _ in fused],
                [dict(m._reductions) for _, m in fused],
                group,
                [m._sync_defaults() for _, m in fused],
            )
            state = {**state, **{name: s for (name, _), s in zip(fused, synced)}}
        res = _flatten_dict({name: mdefs[name].compute(state[name]) for name, _ in members})
        return {collection._set_name(k): v for k, v in res.items()}

    def merge(state_a: Dict[str, Any], state_b: Dict[str, Any], **counts: Any) -> Dict[str, Any]:
        return {name: mdefs[name].merge(state_a[name], state_b[name], **counts) for name, _ in members}

    def _nodes(name: str, m: Metric) -> List[Metric]:
        return _collect_metrics(m) if name in wrapper_names else [m]

    def _node_states(name: str, state: Dict[str, Any]) -> List[Dict[str, Any]]:
        return state[name] if name in wrapper_names else [state[name]]

    def dropped(state: Dict[str, Any]) -> Tensor:
        # straight off the states: the wrapper members' defs would sum over
        # the group a second time
        total = torch.zeros((), dtype=torch.int32, device=device)
        for name, m in members:
            for node, s in zip(_nodes(name, m), _node_states(name, state)):
                total = total + _dropped_in_state(s, device, node._independent_ring_drops)
        return _sum_over(group, total)

    def faults(state: Dict[str, Any]) -> Tensor:
        total = torch.zeros((NUM_FAULT_CLASSES,), dtype=torch.int64, device=device)
        for name, _ in members:
            for s in _node_states(name, state):
                total = total + _faults_in_state(s, device)
        return _sum_over(group, total)

    return MetricDef(init=init, update=update, compute=compute, merge=merge, dropped=dropped, faults=faults)
