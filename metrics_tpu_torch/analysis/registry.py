"""Registry of the flagship paths and their step budgets (counterpart of
``metrics_tpu/analysis/registry.py``).

JAX's entry names, in JAX's order, with JAX's ceilings and shapes; each
entry runs the port's counterpart of JAX's path (ROADMAP D66):

- the stateful ``Metric``/``MetricCollection`` with its fused sync where
  JAX builds a ``functionalize``-d collection (the update captured on the
  card; the sync through :class:`~.graph_audit.MirrorWorld`, a world of
  ``ndev`` = 4);
- the pure layer where JAX uses ``overlapped_functionalize`` (its syncs
  over :data:`~.graph_audit.MIRROR_GROUP`);
- the warmup engine's capture of every ladder tier for ``warmed_*``;
- ``obs.trace`` forced on for ``instrumented_*`` and
  ``traced_fleet_publish``.

Where the port differs, the entry says why:

==============================  =============================================
entry                           budget
==============================  =============================================
``fused_stat_collection``       4-metric StatScores collection syncs in **1**
                                all-reduce (every member's states in the
                                bucket, D12)
``guarded_collection``          guarded collection: **≤ 2** (the fault
                                counters ride the int64 sum bucket, D11)
``sketch_guarded_collection``   guarded collection WITH sketch states: **≤ 2**
``quantized_fused_step``        the same step synced with transport ``int8``:
                                **≤ 2** all-reduces, one ``u8`` all-gather
                                (the wire, D18/D67) and no ``f32`` all-reduce
``auroc_capacity_step``         single-device update + compute: **0**
                                collectives; the update reads nothing back,
                                the compute's reads are pinned (D68)
``mean_update_stability``       recompilation: state shapes batch-size
                                independent, one key at equal shapes
``qsketch_update_step``         QuantileSketch update: **0** collectives, no
                                f64/reads/value-shaped ops, recompile-stable
``drift_live_fold_step``        the drift monitor's live-window fold: **0**
                                collectives, no f64/reads/value-shaped ops,
                                state shapes batch-size independent
``bucketed_rank_step``          descending order + inverse ranks: **0**
``overlapped_fused_step``       the pure overlapped cycle of the guarded
                                4-metric collection: **≤ 2** all-reduces
``chunked_fused_step``          the same cycle with ``sync_chunks=4``: **≤ 2**
                                LOGICAL all-reduces, the 4-chunk schedule
                                pinned in the record
``overlapped_read_step``        the stale read alone: **0** collectives
``ladder_served_update``        ladder-padded guarded update: **0**
                                collectives, and a 13-size ragged sweep keys
                                at most ``len(ladder)`` graphs
``warmed_ladder_serving``       the same after the warmup captured every
                                tier: **0 new** keys over the sweep
``instrumented_update_step``    the guarded update with tracing forced on:
                                **0** collectives, **0** reads
``instrumented_fused_step``     the guarded collection with tracing on: **≤ 2**
``traced_fleet_publish``        the same inside a live trace context: **≤ 2**,
                                **0** reads
``sliced_fused_step``           the guarded 4-metric collection sliced over
                                K=256 cohorts, one pure cycle: **≤ 2**
``warmed_sliced_serving``       a sliced guarded member behind the ladder,
                                warmed: **0 new** keys over the sweep
==============================  =============================================
"""
import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from metrics_tpu_torch.analysis.graph_audit import (
    MIRROR_GROUP,
    GraphBudget,
    GraphViolation,
    MirrorWorld,
    PureTarget,
    StatefulTarget,
    audit_phase,
    audit_recompilation,
    audit_trace,
    collective_counts,
    collective_payload_bytes,
    mirrored,
    physical_collective_counts,
    record_step,
    stand_in_captures,
)

# small sketch geometry: the collective structure under audit is
# geometry-independent (the JAX registry's)
_QS = dict(eps=0.1, k=64, levels=6)


@dataclass(frozen=True)
class AuditEntry:
    name: str
    budget: Optional[GraphBudget]
    # (world, device) -> (step, args): the step is run once, then recorded
    # and checked against `budget`
    build: Optional[Callable[[MirrorWorld, Any], Tuple[Callable, Tuple]]] = None
    # () -> (target, make_args), handed to audit_recompilation
    build_recompile: Optional[Callable[[], Tuple[Any, Callable]]] = None
    sweep_sizes: Optional[Tuple[int, ...]] = None
    max_graphs: Optional[int] = None
    warmup_sizes: Optional[Tuple[int, ...]] = None
    max_new_graphs: int = 0


def _t(array: Any, device: Any) -> Any:
    import torch

    return torch.from_numpy(array).to(device)


def _stat_coll(device: Any, world: MirrorWorld, guarded: bool, members=("acc", "prec", "rec", "f1")):
    import metrics_tpu_torch as mt

    kw = dict(device=device, dist_sync_fn=world)
    if guarded:
        kw["on_invalid"] = "warn"
    make = {
        "acc": lambda: mt.Accuracy(num_classes=4, **kw),
        "prec": lambda: mt.Precision(num_classes=4, average="macro", **kw),
        "rec": lambda: mt.Recall(num_classes=4, average="macro", **kw),
        "f1": lambda: mt.F1Score(num_classes=4, average="macro", **kw),
    }
    return stand_in_captures(mt.MetricCollection({name: make[name]() for name in members}))


def _synced_compute(coll: Any, world: MirrorWorld, transport: str = "exact") -> Tuple[Any, Any]:
    """The collection's values and fault counts after one ``fused_sync``
    of every member's states over ``world`` (the stateful counterpart of
    JAX's ``cdef.compute``/``cdef.faults`` under ``axis_name``); the local
    states are put back afterwards, so the update's graphs stay bound."""
    import torch

    from metrics_tpu_torch.parallel.sync import fused_sync

    names = list(coll.keys(keep_base=True))
    members = [m for _, m in coll.items(keep_base=True, copy_state=False)]
    with audit_phase("sync"):
        coll._compute_groups_create_state_ref()
        synced = fused_sync(
            [m._state_for_sync(m._state) for m in members],
            [m._reductions for m in members],
            None,
            [m._sync_defaults() for m in members],
            comm=world,
            same_as=coll._same_as(names),
            transport=transport,
        )
    local = [m._state for m in members]
    try:
        for m, s in zip(members, synced):
            object.__setattr__(m, "_state", s)
        with audit_phase("compute"):
            values = coll.compute()
            counts = [m._state["_faults"].counts for m in members if "_faults" in m._state]
            faults = torch.stack(counts).sum(0) if counts else None
    finally:
        for m, s in zip(members, local):
            object.__setattr__(m, "_state", s)
    return values, faults


def _stat_args(batch: int, seed: int, device: Any) -> Tuple[Any, Any]:
    import numpy as np

    rng = np.random.default_rng(seed)
    return _t(rng.random((batch, 4), dtype=np.float32), device), _t(rng.integers(0, 4, batch).astype(np.int64), device)


def _collection_step(coll: Any, world: MirrorWorld, transport: str = "exact") -> Callable:
    def step(*args: Any) -> Any:
        with audit_phase("update"):
            coll.update(*args)
        return _synced_compute(coll, world, transport)

    return step


def _build_fused_stat_collection(world: MirrorWorld, device: Any):
    coll = _stat_coll(device, world, guarded=False)
    return _collection_step(coll, world), _stat_args(8 * world.n, 0, device)


def _build_guarded_collection(world: MirrorWorld, device: Any):
    coll = _stat_coll(device, world, guarded=True, members=("acc", "f1"))
    return _collection_step(coll, world), _stat_args(4 * world.n, 1, device)


def _sketch_coll(world: MirrorWorld, device: Any):
    import metrics_tpu_torch as mt

    kw = dict(device=device, dist_sync_fn=world)
    return stand_in_captures(
        mt.MetricCollection(
            {
                "mean": mt.MeanMetric(nan_strategy="warn", **kw),
                "q": mt.QuantileSketch(on_invalid="drop", quantiles=(0.5, 0.99), **_QS, **kw),
                "cm": mt.CountMinSketch(width=256, **kw),
            }
        )
    )


def _sketch_values(world: MirrorWorld, device: Any):
    import numpy as np

    return (_t(np.random.default_rng(2).random(64 * world.n).astype(np.float32), device),)


def _build_sketch_guarded_collection(world: MirrorWorld, device: Any):
    return _collection_step(_sketch_coll(world, device), world), _sketch_values(world, device)


def _build_quantized_fused_step(world: MirrorWorld, device: Any):
    # the SAME construction as sketch_guarded_collection, synced with the
    # int8 transport: the float sum leaves and the quantile payload leave
    # the buckets for one all_gather of bytes (D18)
    return _collection_step(_sketch_coll(world, device), world, transport="int8"), _sketch_values(world, device)


def _auroc_make(device: Any):
    import metrics_tpu_torch as mt

    return mt.AUROC(capacity=64, on_invalid="drop", device=device)


def _auroc_make_args(batch: int, device: Any):
    import numpy as np

    rng = np.random.default_rng(batch)
    return (_t(rng.random(batch, dtype=np.float32), device), _t((rng.random(batch) > 0.5).astype(np.int64), device)), {}


def _build_auroc_capacity_step(world: MirrorWorld, device: Any):
    m = stand_in_captures(_auroc_make(device))

    def step(p: Any, t: Any) -> Any:
        with audit_phase("update"):
            m.update(p, t)
        with audit_phase("compute"):
            return m.compute(), m._state["_faults"].counts

    return step, _auroc_make_args(32, device)[0]


def _build_mean_update_stability():
    import metrics_tpu_torch as mt

    def make_args(batch: int, device: Any):
        import numpy as np

        return (_t(np.linspace(0.0, 1.0, batch, dtype=np.float32), device),), {}

    return StatefulTarget(lambda device: mt.MeanMetric(nan_strategy="warn", device=device)), make_args


def _qsketch_make(device: Any):
    import metrics_tpu_torch as mt

    return mt.QuantileSketch(quantiles=(0.5, 0.99), device=device, **_QS)


def _qsketch_make_args(batch: int, device: Any):
    import numpy as np

    return (_t(np.linspace(0.0, 1.0, batch, dtype=np.float32), device),), {}


def _build_qsketch_update_step(world: MirrorWorld, device: Any):
    m = stand_in_captures(_qsketch_make(device))

    def step(v: Any) -> None:
        with audit_phase("update"):
            m.update(v)

    return step, _qsketch_make_args(96, device)[0]


def _drift_raw_fold(device: Any):
    """(init, fold): the drift monitor's ONLY device work, one batch into
    the three live-window sketches (scoring stays host-side)."""
    from metrics_tpu_torch.obs.drift import fold_live_window
    from metrics_tpu_torch.streaming.sketches import CountMinState, HllState, QuantileSketchState

    def init():
        return (
            QuantileSketchState.create(device=device, **_QS),
            CountMinState.create(depth=4, width=256, device=device),
            HllState.create(precision=8, device=device),
        )

    def fold(states, values):
        return fold_live_window(*states, values)

    return init, fold


def _build_drift_live_fold_step(world: MirrorWorld, device: Any):
    init, fold = _drift_raw_fold(device)
    states = init()

    def step(values: Any) -> Any:
        with audit_phase("update"):
            return fold(states, values)

    return step, _qsketch_make_args(96, device)[0]


def _build_bucketed_rank_step(world: MirrorWorld, device: Any):
    import numpy as np

    from metrics_tpu_torch.ops.bucketed_rank import descending_order, inverse_permutation

    def step(x: Any) -> Any:
        with audit_phase("update"):
            return inverse_permutation(descending_order(x))  # per-element descending ranks

    return step, (_t(np.random.default_rng(3).random(256, np.float32), device),)


def _overlapped_coll(device: Any):
    """The guarded fused 4-metric collection (StatScores family sharing one
    compute-group state, fault channel on)."""
    import metrics_tpu_torch as mt

    kw = dict(on_invalid="warn", device=device)
    return mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=4, **kw),
            "prec": mt.Precision(num_classes=4, average="macro", **kw),
            "rec": mt.Recall(num_classes=4, average="macro", **kw),
            "f1": mt.F1Score(num_classes=4, average="macro", **kw),
        }
    )


def _overlapped_make_args(batch: int, device: Any):
    p, t = _stat_args(batch, batch, device)
    return (p, t), {}


def _pure_cycle_step(odef: Any) -> Callable:
    def step(*args: Any, **kwargs: Any) -> Any:
        with audit_phase("update"):
            s = odef.update(odef.init(), *args, **kwargs)  # live buffer only: no collectives
        with audit_phase("sync"):
            s = odef.cycle(s)  # THE sync cycle: one fused_sync over every leaf
        with audit_phase("compute"):
            return odef.read(s)

    return step


def _overlapped_recompile_target(make_coll: Callable[[Any], Any]) -> PureTarget:
    import metrics_tpu_torch as mt

    def make(device: Any):
        # single-process form (group=None): the cycle copies `live`, the
        # double-buffered layout is the one a group syncs
        odef = mt.overlapped_functionalize(make_coll(device))
        return odef.init, lambda s, *a, **k: odef.cycle(odef.update(s, *a, **k))

    return PureTarget(make)


def _build_overlapped_fused_step(world: MirrorWorld, device: Any):
    import metrics_tpu_torch as mt

    odef = mt.overlapped_functionalize(_overlapped_coll(device), group=MIRROR_GROUP)
    return _pure_cycle_step(odef), _overlapped_make_args(8 * world.n, device)[0]


def _build_chunked_fused_step(world: MirrorWorld, device: Any):
    import metrics_tpu_torch as mt

    # the SAME cycle with the pipelined chunk schedule (explicit
    # sync_chunks=4: the env knob's floor would keep this small state whole)
    odef = mt.overlapped_functionalize(_overlapped_coll(device), group=MIRROR_GROUP, sync_chunks=4)
    return _pure_cycle_step(odef), _overlapped_make_args(8 * world.n, device)[0]


def _build_overlapped_read_step(world: MirrorWorld, device: Any):
    import metrics_tpu_torch as mt

    odef = mt.overlapped_functionalize(_overlapped_coll(device), group=MIRROR_GROUP)
    # one eager update so the members' data-inferred attributes exist; the
    # audited step is the read alone (its structure is state-independent)
    args, _ = _overlapped_make_args(8, device)
    state0 = odef.update(odef.init(), *args)

    def read(state: Any) -> Any:
        with audit_phase("compute"):
            return odef.read(state)

    return read, (state0,)


@contextlib.contextmanager
def _traced(context_span: Optional[str] = None):
    from metrics_tpu_torch.obs.trace import force_tracing, span

    with force_tracing(True):
        with span(context_span) if context_span else contextlib.nullcontext():
            yield


def _build_instrumented_update_step(world: MirrorWorld, device: Any):
    import metrics_tpu_torch as mt

    # the module runtime's own update (captured on the card) on a guarded
    # metric, with tracing forced on
    m = stand_in_captures(mt.Accuracy(num_classes=4, on_invalid="warn", device=device))

    def step(p: Any, t: Any) -> None:
        with _traced(), audit_phase("update"):
            m.update(p, t)

    return step, _overlapped_make_args(32, device)[0]


def _build_instrumented_fused_step(world: MirrorWorld, device: Any):
    step, args = _build_guarded_collection(world, device)

    def traced(*a: Any) -> Any:
        with _traced():
            return step(*a)

    return traced, args


def _build_traced_fleet_publish(world: MirrorWorld, device: Any):
    # the serving graph whose results a FleetPublisher ships (the guarded
    # fused collection), inside a live causal trace context
    step, args = _build_guarded_collection(world, device)

    def traced(*a: Any) -> Any:
        with _traced("audit.traced_fleet_publish"):
            return step(*a)

    return traced, args


# the serving ladder under audit: pinned programmatically (not via the env
# var) so the audit result cannot depend on ambient METRICS_TPU_PAD_LADDER
_SERVE_LADDER = (8, 32, 128)
_SWEEP = (1, 3, 7, 8, 9, 20, 31, 32, 33, 57, 100, 127, 128)


def _ladder_make(device: Any):
    import metrics_tpu_torch as mt

    # the serving-shaped path: a guarded stat-scores-family metric, the row
    # drop in the update (`_valid_mask_always`), the pad mask AND-ed in
    return mt.Accuracy(num_classes=4, on_invalid="drop", device=device)


def _ladder_make_args(batch: int, device: Any):
    from metrics_tpu_torch.ops.padding import pad_rows

    p, t = _stat_args(batch, batch, device)
    # padding happens OUTSIDE the update (the runtime's pad_batches stance):
    # the captured update only ever sees _SERVE_LADDER tiers
    (p, t), valid = pad_rows((p, t), ladder=_SERVE_LADDER)
    return (p, t), {"valid": valid}


def _build_ladder_served_step(world: MirrorWorld, device: Any):
    m = stand_in_captures(_ladder_make(device))
    args, kwargs = _ladder_make_args(32, device)

    def step(p: Any, t: Any, valid: Any) -> Any:
        with audit_phase("update"):
            m.update(p, t, valid=valid)
        with audit_phase("compute"):
            return m.compute(), m._state["_faults"].counts

    return step, args + (kwargs["valid"],)


_SLICED_K = 256


def _sliced_coll(device: Any):
    """The guarded fused 4-metric collection with every member sliced over
    K=256 cohorts: the (K+2,) rings land in the same fused_sync buckets."""
    import metrics_tpu_torch as mt

    inner = _overlapped_coll(device)
    return mt.MetricCollection(
        {name: mt.SlicedMetric(m, num_slices=_SLICED_K) for name, m in inner.items(keep_base=True, copy_state=False)}
    )


def _sliced_make_args(batch: int, device: Any):
    import numpy as np

    rng = np.random.default_rng(batch)
    (p, t), _ = _overlapped_make_args(batch, device)
    # a few out-of-range ids per batch: the quarantine routing is part of
    # the audited step, not a separate code path
    ids = rng.integers(0, _SLICED_K, batch).astype(np.int64)
    if batch >= 4:
        ids[-2:] = (_SLICED_K + 7, -3)
    return (p, t), {"slice_ids": _t(ids, device)}


def _build_sliced_fused_step(world: MirrorWorld, device: Any):
    import metrics_tpu_torch as mt

    odef = mt.overlapped_functionalize(_sliced_coll(device), group=MIRROR_GROUP)
    args, kwargs = _sliced_make_args(8 * world.n, device)
    step = _pure_cycle_step(odef)
    return (lambda p, t, ids: step(p, t, slice_ids=ids)), args + (kwargs["slice_ids"],)


def _sliced_ladder_make(device: Any):
    import metrics_tpu_torch as mt

    # the serving-shaped SLICED path: pad rows (valid=False) route to the
    # discard slice, so the wrapper consumes the row mask for any child
    return mt.SlicedMetric(mt.Accuracy(num_classes=4, on_invalid="warn", device=device), num_slices=16)


def _sliced_ladder_make_args(batch: int, device: Any):
    import numpy as np

    from metrics_tpu_torch.ops.padding import pad_rows

    rng = np.random.default_rng(batch)
    p = _t(rng.random((batch, 4), dtype=np.float32), device)
    t = _t(rng.integers(0, 4, batch).astype(np.int64), device)
    ids = _t(rng.integers(0, 16, batch).astype(np.int64), device)
    (p, t, ids), valid = pad_rows((p, t, ids), ladder=_SERVE_LADDER)
    return (p, t), {"slice_ids": ids, "valid": valid}


_ZERO = dict(max_all_reduce=0, max_all_gather=0, max_reduce_scatter=0, max_collective_permute=0, max_all_to_all=0)

# the reads of the eager compute() (D38), measured on the CPU and on the
# card and pinned per entry (D68): the fault policy reads each guarded
# member's counts (`Metric._check_faults`), a sketch its n_seen and NaN
# check, a ring its dropped count (`_check_cat_overflow`). The JAX package
# runs the same checks on the host after its jitted compute, outside the
# graph it audits. No compute here runs a value-shaped op, and every
# update keeps JAX's zero.
COMPUTE_HOST_READS = {
    "guarded_collection": 2,
    "sketch_guarded_collection": 4,
    "quantized_fused_step": 4,
    "auroc_capacity_step": 2,
    "instrumented_fused_step": 2,
    "traced_fleet_publish": 2,
}

REGISTRY: Tuple[AuditEntry, ...] = (
    AuditEntry(
        name="fused_stat_collection",
        budget=GraphBudget(max_all_reduce=1, max_all_gather=0),
        build=_build_fused_stat_collection,
    ),
    AuditEntry(
        name="guarded_collection",
        budget=GraphBudget(max_all_reduce=2, max_all_gather=0, compute_host_reads=COMPUTE_HOST_READS["guarded_collection"]),
        build=_build_guarded_collection,
    ),
    AuditEntry(
        name="sketch_guarded_collection",
        budget=GraphBudget(max_all_reduce=2, compute_host_reads=COMPUTE_HOST_READS["sketch_guarded_collection"]),
        build=_build_sketch_guarded_collection,
    ),
    AuditEntry(
        name="quantized_fused_step",
        budget=GraphBudget(
            max_all_reduce=2,
            compute_host_reads=COMPUTE_HOST_READS["quantized_fused_step"],
            # the wire pinned structurally (D18/D67): one all_gather of
            # bytes carries the codec's wire, and no float32 payload rides an
            # all_reduce (the counter buckets stay integer-exact)
            require_patterns=(r"(?m)^all-gather u8\[",),
            forbid_patterns=(r"(?m)^all-reduce f32\[",),
        ),
        build=_build_quantized_fused_step,
    ),
    AuditEntry(
        name="auroc_capacity_step",
        budget=GraphBudget(compute_host_reads=COMPUTE_HOST_READS["auroc_capacity_step"], **_ZERO),
        build=_build_auroc_capacity_step,
        build_recompile=lambda: (StatefulTarget(_auroc_make), _auroc_make_args),
    ),
    AuditEntry(
        name="mean_update_stability",
        budget=None,
        build_recompile=_build_mean_update_stability,
    ),
    AuditEntry(
        name="qsketch_update_step",
        budget=GraphBudget(**_ZERO),
        build=_build_qsketch_update_step,
        build_recompile=lambda: (StatefulTarget(_qsketch_make), _qsketch_make_args),
    ),
    AuditEntry(
        name="drift_live_fold_step",
        budget=GraphBudget(**_ZERO),
        build=_build_drift_live_fold_step,
        build_recompile=lambda: (PureTarget(_drift_raw_fold), _qsketch_make_args),
    ),
    AuditEntry(
        name="bucketed_rank_step",
        budget=GraphBudget(**_ZERO),
        build=_build_bucketed_rank_step,
    ),
    AuditEntry(
        name="overlapped_fused_step",
        budget=GraphBudget(max_all_reduce=2, max_all_gather=0),
        build=_build_overlapped_fused_step,
        build_recompile=lambda: (_overlapped_recompile_target(_overlapped_coll), _overlapped_make_args),
    ),
    AuditEntry(
        name="chunked_fused_step",
        budget=GraphBudget(
            # "≤2 all-reduces OR an equivalent chunked schedule": the chunks
            # of one bucket fold into ONE logical collective, and the pin
            # proves the 4-chunk schedule ran
            max_all_reduce=2,
            max_all_gather=0,
            require_patterns=(r"chunk_0of4",),
        ),
        build=_build_chunked_fused_step,
    ),
    AuditEntry(
        name="overlapped_read_step",
        budget=GraphBudget(**_ZERO),
        build=_build_overlapped_read_step,
    ),
    AuditEntry(
        name="ladder_served_update",
        budget=GraphBudget(**_ZERO),
        build=_build_ladder_served_step,
        build_recompile=lambda: (StatefulTarget(_ladder_make), _ladder_make_args),
        # every tier of _SERVE_LADDER appears in the sweep, so the budget is
        # exact: len(ladder) graphs, never one per distinct batch size
        sweep_sizes=_SWEEP,
        max_graphs=3,  # == len(_SERVE_LADDER)
    ),
    AuditEntry(
        name="warmed_ladder_serving",
        budget=None,
        # the ladder_served_update construction after the warmup engine's
        # capture of every _SERVE_LADDER tier: the SAME ragged sweep keys 0
        # new graphs; a tier dropped from warmup_sizes fails the entry
        build_recompile=lambda: (StatefulTarget(_ladder_make), _ladder_make_args),
        sweep_sizes=_SWEEP,
        warmup_sizes=_SERVE_LADDER,
        max_new_graphs=0,
    ),
    AuditEntry(
        name="instrumented_update_step",
        budget=GraphBudget(**_ZERO),
        build=_build_instrumented_update_step,
    ),
    AuditEntry(
        name="instrumented_fused_step",
        budget=GraphBudget(max_all_reduce=2, max_all_gather=0, compute_host_reads=COMPUTE_HOST_READS["instrumented_fused_step"]),
        build=_build_instrumented_fused_step,
    ),
    AuditEntry(
        name="traced_fleet_publish",
        budget=GraphBudget(max_all_reduce=2, max_all_gather=0, compute_host_reads=COMPUTE_HOST_READS["traced_fleet_publish"]),
        build=_build_traced_fleet_publish,
    ),
    AuditEntry(
        name="sliced_fused_step",
        # slicing widens payloads (K+2 rows a leaf), it never adds collectives
        budget=GraphBudget(max_all_reduce=2, max_all_gather=0),
        build=_build_sliced_fused_step,
        build_recompile=lambda: (_overlapped_recompile_target(_sliced_coll), _sliced_make_args),
    ),
    AuditEntry(
        name="warmed_sliced_serving",
        budget=None,
        build_recompile=lambda: (StatefulTarget(_sliced_ladder_make), _sliced_ladder_make_args),
        sweep_sizes=_SWEEP,
        warmup_sizes=_SERVE_LADDER,
        max_new_graphs=0,
    ),
)


def resolve_device(device: Any = None) -> Any:
    """The audit's device: CUDA unless the caller asks for the CPU; raises
    without a card (the port never moves work to the CPU by itself, D53)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the step audit runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' (--device cpu) to audit on the CPU"
        )
    return dev


def run_entry_step(entry: AuditEntry, world: MirrorWorld, device: Any) -> Tuple[Callable, Tuple, Any]:
    """Build ``entry``'s step, run it once unrecorded (the first update at
    a key runs the value checks, D1; the second is the one a replay runs),
    and return ``(step, args, trace)`` of the recorded second call."""
    step, args = entry.build(world, device)
    with mirrored(world):
        step(*args)
    _, trace = record_step(step, args, world=world)
    return step, args, trace


def run_graph_audit(
    entries: Optional[Tuple[AuditEntry, ...]] = None,
    ndev: int = 4,
    device: Any = None,
    report: Optional[Dict[str, Dict[str, Any]]] = None,
) -> List[GraphViolation]:
    """Audit every registry entry on ``device`` (default CUDA); returns all
    violations (empty = pass). ``report``, when given, receives per entry
    the logical and physical collective counts, payload bytes, reads and
    value-shaped ops by phase, and the recompilation checks' keys and
    captures."""
    device = resolve_device(device)
    violations: List[GraphViolation] = []
    for entry in entries if entries is not None else REGISTRY:
        row: Dict[str, Any] = {}
        if entry.build is not None and entry.budget is not None:
            world = MirrorWorld(ndev)
            _, _, trace = run_entry_step(entry, world, device)
            violations.extend(audit_trace(trace, entry.budget, entry=entry.name))
            row.update(step_summary(trace))
        if entry.build_recompile is not None:
            target, make_args = entry.build_recompile()
            graphs: Dict[str, Any] = {}
            violations.extend(
                audit_recompilation(
                    target,
                    make_args,
                    entry=entry.name,
                    sweep_sizes=entry.sweep_sizes,
                    max_graphs=entry.max_graphs,
                    warmup_sizes=entry.warmup_sizes,
                    max_new_graphs=entry.max_new_graphs,
                    device=device,
                    report=graphs,
                )
            )
            row["graphs"] = graphs
            row["captured"] = target.captured
        if report is not None:
            report[entry.name] = row
    return violations


def step_summary(trace: Any) -> Dict[str, Any]:
    """The numbers of one recorded step, by name."""
    reads: Dict[str, int] = {}
    for _, phase in trace.host_reads:
        reads[phase] = reads.get(phase, 0) + 1
    shaped: Dict[str, int] = {}
    for op in trace.flagged("dynamic-shape"):
        shaped[op.phase] = shaped.get(op.phase, 0) + 1
    return {
        "collectives": {k: v for k, v in collective_counts(trace).items() if v},
        "physical_collectives": {k: v for k, v in physical_collective_counts(trace).items() if v},
        "collective_bytes": {k: v for k, v in collective_payload_bytes(trace).items() if v},
        "host_reads": reads,
        "dynamic_shapes": shaped,
        "f64_ops": len(trace.flagged("f64")),
        "aten_ops": len(trace.ops),
    }
