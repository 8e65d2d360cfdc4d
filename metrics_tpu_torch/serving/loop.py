"""The serving loop (counterpart of ``metrics_tpu/serving/loop.py``).

A thread-safe loop: a replica per worker, merged reads, shedding on a full
queue.

The ``Metric`` runtime is single-threaded: two threads updating one metric
race on its states. A :class:`ServeLoop` serves a metric (or a
``MetricCollection``) under concurrent traffic by three rules:

1. **Accumulation is confined to a thread.** Each worker owns a replica (a
   clone of the served metric) and is the only thread that updates it,
   under the replica's lock; a padded, guarded replica replays its
   captured update graphs (``_capture.py``).
2. **Reads merge and never block ingestion.** A background reducer (an
   :class:`~metrics_tpu_torch.parallel.async_sync.AsyncSyncScheduler`
   cycle, the mechanism of ``Metric(sync_mode="overlapped")``) sweeps the
   replicas and folds their states into a fresh reporter clone through the
   metrics' own merge rules (``_reduce_states``, ``sketch_merge``), then
   computes it. ``report()`` serves the last view and its staleness;
   ``report(fresh=True, deadline_s=...)`` waits, at most the deadline, for
   a view that covers every update processed when it was called.
3. **Overload sheds loudly.** Ingestion is a bounded queue: ``offer`` on a
   full queue drops the request, counts it and records an ``overload_shed``
   health event, so ``accepted + shed == offered`` always holds.

Publication. The JAX package publishes a replica's arrays by reference,
since they are immutable. The port's states change in place, so the sweep
copies each replica's states on the card under the replica's lock, with no
read back: the copy costs the states' bytes once per replica and reduce
cycle, not per request.

Streams. Workers update, replay their graphs and the sweep copies on the
current stream of their threads, the device's default stream, so every
copy is ordered after the updates it covers and no tensor crosses streams.
A capture records on a side stream of the capturing thread and runs
nothing there.

A request that fails is counted (``serve_update_error``), and the replica's
bindings, update counts, ``jittable_update`` and data-inferred attributes
are put back. The port's updates check their arguments before they write
their states in place (D8); a state written before the failure is not
undone.

Snapshots, drift and telemetry, as in the JAX package:

- ``snapshot_manager=`` (a :class:`~metrics_tpu_torch.resilience.SnapshotManager`)
  and ``snapshot_every_s=`` ride the reducer's tick: each replica saves as
  one rank of a ``world_size=workers`` group (:meth:`ServeLoop.save_snapshot`),
  so a restore works at any worker count through the elastic merge.
  :meth:`ServeLoop.restore_snapshot` loads the newest intact group into a
  base state that joins every later reduce; its tensors are new, so a
  replica's captured graphs are never bound to them.
- ``drift_monitors=`` (:class:`~metrics_tpu_torch.obs.DriftMonitor`): each
  monitor watches the accepted traffic (``offer`` calls its
  ``extract_from`` and ``observe``, which read nothing back) and is checked
  on the reducer's tick.
- The ``serve.offer``, ``serve.update``, ``serve.reduce``,
  ``serve.forced_reduce`` and ``serve.drift_check`` spans, with the offer's
  context handed to the worker's update; :meth:`ServeLoop.scrape` renders
  :meth:`ServeLoop.health` with the self-telemetry. The loop's host view
  of its health (no device read: the fault counts are the ones the last
  reduce read back) is a flight-recorder source.

The fleet seams (``fleet/``): :meth:`ServeLoop.fleet_view`,
:meth:`ServeLoop.fleet_trace_context` and :meth:`ServeLoop.fleet_extra` are
a :class:`~metrics_tpu_torch.fleet.FleetPublisher`'s source hooks, as in the
JAX package. ``fleet_view()`` is the last reporter's ``snapshot_state()``,
which reads the card's states back on the publisher's thread, never on the
request path, and once per reduce: publishes between two reduces reuse it
(the JAX package snapshots the reporter at every publish).

``threading.Lock`` stands where the JAX package uses ``named_lock`` (item 18).
"""
import copy
import itertools
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.obs import trace as _obs_trace
from metrics_tpu_torch.parallel.async_sync import AsyncSyncScheduler
from metrics_tpu_torch.resilience.health import health_report, record_degradation
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError

__all__ = ["ServeLoop"]

# one replica's published form: {member name: (state copy, update count,
# data-inferred attributes by child path)}
_Snapshot = Dict[str, Tuple[Dict[str, Any], int, Dict[str, Dict[str, Any]]]]


def _attr_slots(m: Any, prefix: str = "") -> List[Tuple[Tuple[str, str], Any]]:
    """Every ``_snapshot_attrs`` slot of a metric tree as ``((path, attr),
    value)`` pairs in tree order, ``None`` slots included."""
    out: List[Tuple[Tuple[str, str], Any]] = [((prefix, a), getattr(m, a, None)) for a in m._snapshot_attrs]
    for name, child in m._named_child_metrics():
        out.extend(_attr_slots(child, f"{prefix}.{name}" if prefix else name))
    return out


def _inferred_attrs(m: Any, prefix: str = "") -> Dict[str, Dict[str, Any]]:
    """The data-inferred attributes of a metric and its children that are
    set, by dotted child path."""
    out: Dict[str, Dict[str, Any]] = {}
    for (path, attr), value in _attr_slots(m, prefix):
        if value is not None:
            out.setdefault(path, {})[attr] = value
    return out


def _apply_inferred_attrs(m: Any, attrs_by_path: Dict[str, Dict[str, Any]]) -> None:
    """Set the attributes that are still ``None`` (the first value wins, as
    an update infers once and keeps it); unknown paths are skipped."""
    children = None
    for path, attrs in attrs_by_path.items():
        if path:
            if children is None:
                children = dict(m._named_child_metrics())
            head = path.split(".", 1)
            if head[0] in children:
                _apply_inferred_attrs(children[head[0]], {head[1] if len(head) > 1 else "": attrs})
            continue
        for a, v in attrs.items():
            if getattr(m, a, None) is None:
                setattr(m, a, v)


def _attr_cells(m: Any) -> List[Tuple[Any, str, Any]]:
    """``(owner, attr, value)`` for every ``_snapshot_attrs`` slot of a
    metric tree, ``None`` included, so a rollback can unset what a failed
    update inferred."""
    out: List[Tuple[Any, str, Any]] = [(m, a, getattr(m, a, None)) for a in m._snapshot_attrs]
    for _, child in m._named_child_metrics():
        out.extend(_attr_cells(child))
    return out


def _is_collection(obj: Any) -> bool:
    return hasattr(obj, "_modules") and hasattr(obj, "items")


def _clone(obj: Any) -> Any:
    new = copy.deepcopy(obj)
    new.reset()
    return new


def _members(obj: Any) -> List[Tuple[str, Any]]:
    """``(name, Metric)`` pairs; one ``("", obj)`` for a bare metric. The
    states are not copied (a compute group keeps its aliasing)."""
    if _is_collection(obj):
        return list(obj.items(keep_base=True, copy_state=False))
    return [("", obj)]


def _snapshot_of(obj: Any) -> _Snapshot:
    """Copies of one replica's states, taken while its worker is held off."""
    return {name: (m._copy_state(), m._update_count, _inferred_attrs(m)) for name, m in _members(obj)}


def _fold_snapshot(target: Any, snap: _Snapshot) -> None:
    """Merge one snapshot into ``target`` by the metrics' merge rules, its
    update count the weight of a ``mean`` state; the data-inferred
    attributes carry over (the first value wins)."""
    for name, m in _members(target):
        state, count, attrs = snap[name]
        if count == 0:
            continue
        _apply_inferred_attrs(m, attrs)
        merged = m._reduce_states(m._copy_state(), state, m._update_count, batch_count=count)
        object.__setattr__(m, "_state", merged)
        m._update_count += count
        m._update_called = True
        m._computed = None


class ServeLoop:
    """Serve a metric (or a ``MetricCollection``) under concurrent traffic.

    Example::

        loop = ServeLoop(Accuracy(num_classes=10, on_invalid="drop",
                                  pad_batches=True), workers=4)
        ok = loop.offer(preds, target)        # False: shed (queue full)
        view = loop.report()                   # last reduced value, staleness_s
        view = loop.report(fresh=True, deadline_s=0.2)
        loop.stop()

    ``metric`` is the prototype: every worker gets a fresh clone, and reads
    merge the clones; the caller's instance is never touched.

    ``warmup=`` takes a :class:`~metrics_tpu_torch.serving.Warmup` (one
    representative request) and starts a
    :class:`~metrics_tpu_torch.serving.WarmupEngine`: on a background thread
    it captures every replica's update graphs for every ladder tier, largest
    first, so a warmed tier serves its first request from a graph.
    ``METRICS_TPU_WARMUP=0`` skips it. A warmup that fails records
    ``serve_warmup_error`` and serving goes on with eager first updates.

    ``sync_transport`` (``ops/quantize.py``; None resolves
    ``METRICS_TPU_SYNC_TRANSPORT``, else ``exact``) is the wire of the
    reducer's sync in a multi-process world; the in-process fold moves no
    bytes.

    ``snapshot_manager=`` with ``snapshot_every_s=`` saves the served
    state periodically, each replica as one rank; ``drift_monitors=`` (one
    :class:`~metrics_tpu_torch.obs.DriftMonitor`, a list, or a ``{name:
    monitor}`` dict) watch the accepted traffic and are checked on the
    reducer's cadence.
    """

    def __init__(
        self,
        metric: Any,
        workers: int = 2,
        queue_size: int = 256,
        reduce_every_s: float = 0.25,
        snapshot_manager: Optional[Any] = None,
        snapshot_every_s: Optional[float] = None,
        sync_transport: Optional[str] = None,
        warmup: Optional[Any] = None,
        drift_monitors: Optional[Any] = None,
    ) -> None:
        if workers < 1:
            raise ValueError(f"`workers` must be >= 1, got {workers}")
        if queue_size < 1:
            raise ValueError(f"`queue_size` must be >= 1, got {queue_size}")
        if snapshot_every_s is not None and snapshot_manager is None:
            raise ValueError("`snapshot_every_s` needs a `snapshot_manager`")
        from metrics_tpu_torch.ops.quantize import validate_transport

        self.sync_transport = validate_transport(sync_transport)
        self.workers = workers
        self.reduce_every_s = float(reduce_every_s)
        self._proto = metric
        self._replicas = [_clone(metric) for _ in range(workers)]
        # held by a worker around each update, by the sweep around each copy
        # and by the warmup around each capture
        self._replica_locks = [threading.Lock() for _ in range(workers)]
        self._published = [False] * workers
        self._base_snap: Optional[_Snapshot] = None  # a restored state

        self._queue: "queue.Queue[Tuple[tuple, dict]]" = queue.Queue(maxsize=queue_size)
        self._stats_lock = threading.Lock()
        self._offered = 0
        self._accepted = 0
        self._shed = 0
        self._processed = 0
        self._failed = 0
        self._dead_workers = 0
        self._stopping = False
        self._last_reporter: Optional[Any] = None
        # workers stop (after draining the backlog) before the reducer's
        # final pass, so the final view covers every processed request
        self._stop_workers = threading.Event()

        self._snapshot_mgr = snapshot_manager
        self._snapshot_every_s = snapshot_every_s
        self._snapshot_step = itertools.count(1)
        self._snapshot_step_lock = threading.Lock()
        self._last_snapshot_unix = time.time()

        # drift monitors: observed on the offer path (no read back), checked
        # on the scheduler's tick
        self._drift: Dict[str, Any] = {}
        self._drift_error_reported: Dict[str, bool] = {}  # episode-gated
        # any failing observe/check since the last tick: the episode re-arms
        # only after a clean interval
        self._drift_error_recent: Dict[str, bool] = {}
        if drift_monitors is not None:
            if isinstance(drift_monitors, dict):
                for key, monitor in drift_monitors.items():
                    if key != getattr(monitor, "name", None):
                        raise MetricsTPUUserError(
                            f"drift_monitors key {key!r} != monitor.name "
                            f"{getattr(monitor, 'name', None)!r}; gauges and events are "
                            "labeled by the monitor's own name — use matching keys "
                            "(or pass a list)"
                        )
                monitors = list(drift_monitors.values())
            elif isinstance(drift_monitors, (list, tuple)):
                monitors = list(drift_monitors)
            else:
                monitors = [drift_monitors]
            for monitor in monitors:
                name = getattr(monitor, "name", None)
                if not name or not callable(getattr(monitor, "check", None)):
                    raise MetricsTPUUserError(
                        "`drift_monitors` must be DriftMonitor instances (or a "
                        f"list/dict of them), got {type(monitor).__name__}"
                    )
                if name in self._drift:
                    raise MetricsTPUUserError(
                        f"duplicate drift monitor name {name!r}: each monitor needs a "
                        "distinct name (it labels the exported gauges)"
                    )
                self._drift[name] = monitor
                self._drift_error_reported[name] = False
                self._drift_error_recent[name] = False

        self._scheduler = AsyncSyncScheduler(
            snapshot_fn=self._sweep_published,
            reduce_fn=self._reduce_view,
            sync_every_n=None,
            sync_every_s=self.reduce_every_s,
            tick_fn=self._snapshot_tick,
            on_error=self._on_reduce_error,
            name=f"serve-{type(metric).__name__}",
        )

        # causal tracing: the context of the newest update span and of the
        # reduce that built the last reporter
        self._publish_ctx = None
        self._last_reporter_ctx = None
        self._fleet_view_cache: Optional[Tuple[Any, Dict[str, Any]]] = None  # (reporter, payload)

        # the flight recorder reads this loop's host view; detached at stop
        from metrics_tpu_torch.obs import flightrec as _flightrec

        self._flightrec_token = _flightrec.attach_source(f"serve:{type(metric).__name__}", self._host_health)

        self._warmup = None
        if warmup is not None:
            from metrics_tpu_torch.serving.warmup import WarmupEngine, warmup_enabled

            if warmup_enabled():
                self._warmup = WarmupEngine(metric, warmup, name=type(metric).__name__)

        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True, name=f"serve-worker-{i}")
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()
        if self._warmup is not None:
            self._warmup.start(self._replicas, self._replica_locks)

    # -- ingestion ------------------------------------------------------

    def offer(self, *args: Any, **kwargs: Any) -> bool:
        """Queue one update batch; False when it was shed (queue full:
        counted and recorded, never silent)."""
        shed = None
        with _obs_trace.span("serve.offer"):
            # the offer's context rides the queue item: the worker's update
            # span becomes its child (None while tracing is off)
            ctx = _obs_trace.current_context()
            # counted and queued under one lock: a request counted accepted
            # is queued, so accepted + shed == offered at every instant
            with self._stats_lock:
                if self._stopping:
                    raise MetricsTPUUserError("ServeLoop.offer called after stop()")
                self._offered += 1
                try:
                    self._queue.put_nowait((args, kwargs, ctx))
                    self._accepted += 1
                except queue.Full:
                    self._shed += 1
                    shed = self._shed
        if shed is not None:
            record_degradation(
                "overload_shed",
                f"serve queue full ({self._queue.maxsize}); request shed",
                shed_total=shed,
                metric=type(self._proto).__name__,
            )
            return False
        # drift monitors watch the accepted traffic; a monitor's failure
        # degrades loudly and never takes the request with it
        for name, monitor in self._drift.items():
            try:
                values = monitor.extract_from(args, kwargs)
                if values is not None:
                    monitor.observe(values)
            except Exception as err:  # noqa: BLE001 - drift degrades, never sheds
                self._record_drift_error(name, err, during="observe")
        return True

    def _worker(self, i: int) -> None:
        # a worker that dies outside the stop handshake is loud: its share
        # of the backlog no longer drains
        try:
            self._worker_loop(i)
        finally:
            if not self._stop_workers.is_set():
                with self._stats_lock:
                    self._dead_workers += 1
                record_degradation(
                    "serve_worker_died",
                    f"worker {i} exited outside the stop handshake; its queue share no longer drains "
                    "(its published state keeps serving)",
                    worker=i,
                    metric=type(self._proto).__name__,
                )

    def _worker_loop(self, i: int) -> None:
        replica, lock = self._replicas[i], self._replica_locks[i]
        while True:
            try:
                args, kwargs, offer_ctx = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop_workers.is_set():
                    return
                continue
            try:
                with lock:
                    bookkeeping = [
                        (m, dict(m._state), m._update_count, m.jittable_update, _attr_cells(m))
                        for _, m in _members(replica)
                    ]
                    try:
                        # the request-latency seam (serve_update_ms), the
                        # offer's span its parent across the threads
                        with _obs_trace.trace_context(offer_ctx):
                            with _obs_trace.span("serve.update", worker=i):
                                self._publish_ctx = _obs_trace.current_context()
                                replica.update(*args, **kwargs)
                    except Exception:
                        for m, state, count, jittable, cells in bookkeeping:
                            object.__setattr__(m, "_state", state)
                            m._update_count = count
                            object.__setattr__(m, "jittable_update", jittable)
                            for owner, attr, value in cells:
                                setattr(owner, attr, value)
                        raise
                    self._published[i] = True
            except Exception as err:  # noqa: BLE001 - one bad request must not kill the worker
                with self._stats_lock:
                    self._failed += 1
                record_degradation(
                    "serve_update_error",
                    f"worker {i} update raised {type(err).__name__}: {err}",
                    metric=type(self._proto).__name__,
                )
            else:
                # after the update: the coverage watermark stays a lower bound
                self._scheduler.notify()
            finally:
                with self._stats_lock:
                    self._processed += 1
                self._queue.task_done()

    # -- reduction and reads ----------------------------------------------

    def _sweep_published(self) -> Tuple[List[_Snapshot], Optional[int]]:
        """The scheduler's snapshot: a copy of every replica that has
        served, each under its lock. Steps None: the scheduler counts
        publishes."""
        snaps = [self._base_snap] if self._base_snap is not None else []
        for i, replica in enumerate(self._replicas):
            with self._replica_locks[i]:
                if self._published[i]:
                    snaps.append(_snapshot_of(replica))
        return snaps, None

    def _reduce_view(self, snaps: List[_Snapshot]) -> Dict[str, Any]:
        """The scheduler's reduce: a fresh reporter clone, every snapshot
        folded in, then computed. A failure keeps the previous view. The
        span links to the newest update span (a reduce fans in many)."""
        with _obs_trace.span("serve.reduce", link_to=self._publish_ctx, snapshots=len(snaps)):
            out = self._reduce_view_inner(snaps)
            self._last_reporter_ctx = _obs_trace.current_context()
            return out

    def _reduce_view_inner(self, snaps: List[_Snapshot]) -> Dict[str, Any]:
        reporter = _clone(self._proto)
        for snap in snaps:
            _fold_snapshot(reporter, snap)
        if snaps:
            self._sync_reporter(reporter)
        value = reporter.compute() if snaps else None
        faults = {}
        for name, m in _members(reporter):
            fc = getattr(m, "fault_counts", None)
            if fc:
                faults[name or type(m).__name__] = fc
        self._last_reporter = reporter
        return {
            "value": value,
            "computed_unix": time.time(),
            "updates": sum(m._update_count for _, m in _members(reporter)),
            "faults": faults,
        }

    def _sync_reporter(self, reporter: Any) -> None:
        """With a quantized ``sync_transport`` in a multi-process world, sync
        the reporter's states on that wire in one ``fused_sync``; its
        ``compute()`` then computes them as they are."""
        from metrics_tpu_torch.ops.quantize import resolve_codec
        from metrics_tpu_torch.parallel.sync import distributed_available, fused_sync

        codec = resolve_codec(self.sync_transport)
        if codec.name == "exact" or not distributed_available():
            return
        units = [m for _, m in _members(reporter)]
        synced = fused_sync(
            [m._state_for_sync(m._state) for m in units],
            [m._reductions for m in units],
            units[0].process_group,
            [m._sync_defaults() for m in units],
            comm=units[0].dist_sync_fn,
            transport="exact",
            host_codec=codec,
        )
        for m, state in zip(units, synced):
            object.__setattr__(m, "_state", state)
            m.sync_on_compute = False

    def _on_reduce_error(self, err: BaseException) -> None:
        record_degradation(
            "serve_reduce_error",
            f"reduce/compute raised {type(err).__name__}: {err}",
            metric=type(self._proto).__name__,
        )

    def _record_drift_error(self, name: str, err: BaseException, during: str) -> None:
        """Once per episode and monitor: the next clean interval re-arms."""
        with self._stats_lock:
            due = not self._drift_error_reported.get(name)
            self._drift_error_reported[name] = True
            self._drift_error_recent[name] = True
        if due:
            record_degradation(
                "drift_check_error",
                f"drift monitor {name!r} {during} raised {type(err).__name__}: {err} "
                "(reported once per episode; the cadence keeps retrying)",
                monitor=name,
            )

    def _drift_tick(self) -> None:
        """Every monitor's check, on the scheduler's wake: fold, score,
        fire or clear episodes, off the request path."""
        for name, monitor in self._drift.items():
            try:
                with _obs_trace.span("serve.drift_check", monitor=name):
                    monitor.check()
                with self._stats_lock:
                    if self._drift_error_recent[name]:
                        self._drift_error_recent[name] = False
                    else:
                        self._drift_error_reported[name] = False
            except Exception as err:  # noqa: BLE001 - drift degrades, never kills the reducer
                self._record_drift_error(name, err, during="check")

    def _snapshot_tick(self) -> Optional[float]:
        """The scheduler's tick: the drift checks, then the periodic
        snapshot when due. Returns the seconds until the next snapshot."""
        if self._drift:
            self._drift_tick()
        if self._snapshot_every_s is None:
            return None
        due_in = self._last_snapshot_unix + self._snapshot_every_s - time.time()
        if due_in > 0:
            return due_in
        try:
            self.save_snapshot()
        except Exception as err:  # noqa: BLE001 - snapshots degrade, never kill serving
            # stamp the attempt: a failing writer retries on the cadence
            self._last_snapshot_unix = time.time()
            record_degradation("serve_snapshot_error", f"periodic snapshot raised {type(err).__name__}: {err}")
        return self._snapshot_every_s

    def report(self, fresh: bool = False, deadline_s: float = 0.5) -> Dict[str, Any]:
        """The merged value as last reduced, never blocking ingestion.

        ``fresh=True`` waits, at most ``deadline_s``, for a view that covers
        every update processed when it was called; on the deadline the stale
        view comes back with ``fresh`` False."""
        got_fresh = False
        if fresh:
            with _obs_trace.span("serve.forced_reduce"):
                got_fresh = self._scheduler.wait_covered(self._scheduler.seq(), deadline_s=max(0.0, deadline_s))
        sync_view = self._scheduler.view()
        view = sync_view.payload if sync_view is not None else None
        value = view["value"] if view else None
        if isinstance(value, dict):
            value = dict(value)
        return {
            "value": value,
            "updates": view["updates"] if view else 0,
            "faults": {k: dict(v) for k, v in view["faults"].items()} if view else {},
            "staleness_s": max(0.0, time.time() - view["computed_unix"]) if view else None,
            "fresh": bool(got_fresh),
            "stats": self.stats(),
        }

    def wait_warmup(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the warmup thread ends (done, failed or stopped); True
        when it did within the timeout, False at once without a warmup."""
        if self._warmup is None:
            return False
        return self._warmup.wait(timeout_s=timeout_s)

    def stats(self) -> Dict[str, int]:
        """Request accounting: ``accepted + shed == offered``."""
        with self._stats_lock:
            return {
                "offered": self._offered,
                "accepted": self._accepted,
                "shed": self._shed,
                "processed": self._processed,
                "failed": self._failed,
                "dead_workers": self._dead_workers,
                "queue_depth": self._queue.qsize(),
            }

    def health(self) -> Dict[str, Any]:
        """``health_report()`` over the merged view, with the serving
        counters, the reducer's lag and the warmup's state."""
        rep = health_report(self._last_reporter) if self._last_reporter is not None else health_report()
        sync_view = self._scheduler.view()
        view = sync_view.payload if sync_view is not None else None
        rep["serving"] = {
            **self.stats(),
            "workers": self.workers,
            "queue_capacity": self._queue.maxsize,
            "report_staleness_s": max(0.0, time.time() - view["computed_unix"]) if view else None,
            "sync": self._scheduler.lag(),
            "warmup": self._warmup.state() if self._warmup is not None else None,
        }
        if self._drift:
            rep["drift"] = {name: m.status() for name, m in self._drift.items()}
        if self._last_reporter is not None:
            from metrics_tpu_torch.sliced import SlicedMetric

            slices = {}
            for name, m in _members(self._last_reporter):
                if isinstance(m, SlicedMetric):
                    try:
                        slices[name or type(m.wrapped).__name__] = m.scrape_slices()
                    except Exception as err:  # noqa: BLE001 - a scrape degrades, never sheds
                        slices[name or type(m.wrapped).__name__] = {"error": f"{type(err).__name__}: {err}"}
            if slices:
                rep["slices"] = slices
        return rep

    def _host_health(self) -> Dict[str, Any]:
        """The loop's health from host data only: the process registry, the
        serving counters, the reducer's lag, the warmup, the drift monitors'
        statuses and the fault counts the last reduce read back. The flight
        recorder reads this (never the device, not even at exit)."""
        rep = health_report()
        sync_view = self._scheduler.view()
        view = sync_view.payload if sync_view is not None else None
        rep["serving"] = {
            **self.stats(),
            "workers": self.workers,
            "queue_capacity": self._queue.maxsize,
            "report_staleness_s": max(0.0, time.time() - view["computed_unix"]) if view else None,
            "sync": self._scheduler.lag(),
            "warmup": self._warmup.state() if self._warmup is not None else None,
            "faults": {k: dict(v) for k, v in view["faults"].items()} if view else {},
        }
        if self._drift:
            rep["drift"] = {name: m.status() for name, m in self._drift.items()}
        return rep

    def scrape(self, fmt: str = "prometheus") -> str:
        """One exporter scrape over this loop: :meth:`health` with the
        process self-telemetry. ``fmt``: ``"prometheus"`` or ``"json"``;
        serve it over HTTP with ``obs.TelemetryExporter(health_fn=loop.health)``."""
        from metrics_tpu_torch.obs.export import json_text, prometheus_text

        if fmt == "prometheus":
            return prometheus_text(health=self.health())
        if fmt == "json":
            return json_text(health=self.health())
        raise MetricsTPUUserError(f"`fmt` must be 'prometheus' or 'json', got {fmt!r}")

    # -- snapshots --------------------------------------------------------

    def save_snapshot(self, step: Optional[int] = None) -> int:
        """One crash-safe snapshot group: worker ``i``'s state (copied under
        its lock) is rank ``i`` of a ``world_size=workers`` group, the
        restored base folded into rank 0, each written by the manager's
        atomic, checksummed writer. Returns the step."""
        if self._snapshot_mgr is None:
            raise MetricsTPUUserError("ServeLoop has no snapshot_manager configured")
        if step is None:
            # never at or below a step already on disk (a restored group's, or
            # an earlier run's): the manager keeps the newest `keep` steps, so
            # a lower step would be pruned as soon as it is written (F11)
            with self._snapshot_step_lock:  # the reducer's periodic saves race explicit ones
                step = max(next(self._snapshot_step), max(self._snapshot_mgr.steps(), default=0) + 1)
                self._snapshot_step = itertools.count(step + 1)
        for i, replica in enumerate(self._replicas):
            scratch = _clone(self._proto)
            if i == 0 and self._base_snap is not None:
                _fold_snapshot(scratch, self._base_snap)
            with self._replica_locks[i]:
                snap = _snapshot_of(replica) if self._published[i] else None
            if snap is not None:
                _fold_snapshot(scratch, snap)
            self._snapshot_mgr.save(scratch, step=step, rank=i, world_size=self.workers)
        self._last_snapshot_unix = time.time()
        return step

    def restore_snapshot(self) -> Dict[str, Any]:
        """Load the newest intact snapshot group (any saved world size) as
        the loop's base state: it joins every later reduce and rank 0 of
        every later snapshot. Only before the loop has served: a restore
        into a loop whose replicas hold updates would count them twice."""
        if self._snapshot_mgr is None:
            raise MetricsTPUUserError("ServeLoop has no snapshot_manager configured")
        if any(self._published):
            raise MetricsTPUUserError(
                "ServeLoop.restore_snapshot on a loop that has already served traffic: "
                "the restored base would double-count the replicas' published updates. "
                "Restore into a fresh ServeLoop before offering requests."
            )
        base = _clone(self._proto)
        info = self._snapshot_mgr.restore(base, rank=0, world_size=1)
        self._base_snap = _snapshot_of(base)
        # the base joins the coverage: report(fresh=True) waits for it
        self._scheduler.notify()
        return info

    # -- fleet source hooks -------------------------------------------------

    def fleet_view(self) -> Optional[Dict[str, Any]]:
        """This loop's merged view as a ``snapshot_state`` payload, the
        :class:`~metrics_tpu_torch.fleet.FleetPublisher` source hook (None
        until the first reduce completes). Each reduce builds a fresh
        reporter and never touches it again, so reading it here never races
        the reducer; the read copies its states to the host once per
        reporter (the JAX package snapshots it at every call), and the
        payload is shared until the next reduce: its readers never write it."""
        reporter = self._last_reporter
        if reporter is None:
            return None
        cached = self._fleet_view_cache
        if cached is not None and cached[0] is reporter:
            return cached[1]
        payload = reporter.snapshot_state()
        self._fleet_view_cache = (reporter, payload)
        return payload

    def fleet_trace_context(self) -> Any:
        """The trace context of the reduce that built the current
        ``fleet_view()`` reporter, so a publish span links back to it; None
        while tracing is off or before the first reduce."""
        return self._last_reporter_ctx

    def fleet_extra(self) -> Optional[Dict[str, Any]]:
        """Header extra for this host's fleet publishes: each drift
        monitor's scores and episode flag (``DriftMonitor.fleet_scores``),
        so the global aggregator's scrape names the drifting host."""
        if not self._drift:
            return None
        return {"drift": {name: m.fleet_scores() for name, m in self._drift.items()}}

    # -- lifecycle --------------------------------------------------------

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait until every accepted request has been processed; False on
        the timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._stats_lock:
                if self._processed >= self._accepted:
                    return True
            time.sleep(0.005)
        return False

    def stop(self, drain: bool = True, timeout_s: float = 10.0) -> None:
        """Stop the workers (after the accepted requests, with ``drain``)
        and run a final reduce, so ``report()`` covers every processed
        request. The workers finish the backlog and join before the
        reducer's final pass."""
        with self._stats_lock:
            self._stopping = True
        # a flight-recorder dump after the stop must not read a dead loop
        from metrics_tpu_torch.obs import flightrec as _flightrec

        _flightrec.detach_source(self._flightrec_token)
        if self._warmup is not None:
            self._warmup.stop(timeout_s=timeout_s)
        if drain:
            self.drain(timeout_s)
        self._stop_workers.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._scheduler.stop(final=True, timeout_s=timeout_s)

    def __enter__(self) -> "ServeLoop":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()
