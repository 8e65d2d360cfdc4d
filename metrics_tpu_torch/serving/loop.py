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

Left out until their items land, and refused with an error that names
them: ``snapshot_manager=``, ``snapshot_every_s=``, ``save_snapshot`` and
``restore_snapshot`` (item 14), ``drift_monitors=`` and ``scrape`` (item
15), the ``fleet_*`` methods (item 16), and the trace, flight-recorder and
``obs`` seams (item 15). ``threading.Lock`` stands where the JAX package
uses ``named_lock`` (item 18).
"""
import copy
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.parallel.async_sync import AsyncSyncScheduler
from metrics_tpu_torch.resilience.health import health_report, record_degradation
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError

__all__ = ["ServeLoop"]

# one replica's published form: {member name: (state copy, update count,
# data-inferred attributes by child path)}
_Snapshot = Dict[str, Tuple[Dict[str, Any], int, Dict[str, Dict[str, Any]]]]


def _left_out(what: str, item: str) -> MetricsTPUUserError:
    return MetricsTPUUserError(f"ServeLoop: {what} is not ported yet (ROADMAP.md, Queue 1, {item})")


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
        if snapshot_manager is not None or snapshot_every_s is not None:
            raise _left_out("`snapshot_manager=`/`snapshot_every_s=`", "item 14")
        if drift_monitors is not None:
            raise _left_out("`drift_monitors=`", "item 15")
        if workers < 1:
            raise ValueError(f"`workers` must be >= 1, got {workers}")
        if queue_size < 1:
            raise ValueError(f"`queue_size` must be >= 1, got {queue_size}")
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

        self._scheduler = AsyncSyncScheduler(
            snapshot_fn=self._sweep_published,
            reduce_fn=self._reduce_view,
            sync_every_n=None,
            sync_every_s=self.reduce_every_s,
            on_error=self._on_reduce_error,
            name=f"serve-{type(metric).__name__}",
        )

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
        # counted and queued under one lock: a request counted accepted is
        # queued, so accepted + shed == offered at every instant
        with self._stats_lock:
            if self._stopping:
                raise MetricsTPUUserError("ServeLoop.offer called after stop()")
            self._offered += 1
            try:
                self._queue.put_nowait((args, kwargs))
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
                args, kwargs = self._queue.get(timeout=0.05)
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
        snaps = []
        for i, replica in enumerate(self._replicas):
            with self._replica_locks[i]:
                if self._published[i]:
                    snaps.append(_snapshot_of(replica))
        return snaps, None

    def _reduce_view(self, snaps: List[_Snapshot]) -> Dict[str, Any]:
        """The scheduler's reduce: a fresh reporter clone, every snapshot
        folded in, then computed. A failure keeps the previous view."""
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

    def report(self, fresh: bool = False, deadline_s: float = 0.5) -> Dict[str, Any]:
        """The merged value as last reduced, never blocking ingestion.

        ``fresh=True`` waits, at most ``deadline_s``, for a view that covers
        every update processed when it was called; on the deadline the stale
        view comes back with ``fresh`` False."""
        got_fresh = False
        if fresh:
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

    # -- left out until their items land ----------------------------------

    def save_snapshot(self, step: Optional[int] = None) -> int:
        raise _left_out("save_snapshot", "item 14")

    def restore_snapshot(self) -> Dict[str, Any]:
        raise _left_out("restore_snapshot", "item 14")

    def scrape(self, fmt: str = "prometheus") -> str:
        raise _left_out("scrape", "item 15")

    def fleet_view(self) -> Optional[Dict[str, Any]]:
        raise _left_out("fleet_view", "item 16")

    def fleet_trace_context(self) -> Any:
        raise _left_out("fleet_trace_context", "item 16")

    def fleet_extra(self) -> Optional[Dict[str, Any]]:
        raise _left_out("fleet_extra", "item 16")

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
