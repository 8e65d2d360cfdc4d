"""The process-wide degradation registry and ``health_report()``
(counterpart of ``metrics_tpu/resilience/health.py``).

Every degradation of the port lands in one bounded, thread-safe
:class:`HealthRegistry` through :func:`record_degradation`: a collective
that fell back to the rank's own state (``gather_degraded``), an overlapped
sync cycle that raised (``async_sync_error``) or overran its deadline
(``async_sync_stalled``). :func:`health_report` renders the registry and,
for the metrics and collections passed in, their fault counters, ring
overflow, staleness and overlapped-sync lag, as one plain dict.

The report's ``backend`` key is the CUDA bootstrap state
(``utilities/backend.py``), its ``runtime`` key the light self-telemetry
summary (``obs/runtime_metrics.py``: counters, histogram counts and sums),
as in the JAX package. Listeners (the flight recorder's degraded-edge
trigger) are called per recorded event, outside the lock.

The registry imports the standard library only, so it stays usable when
the device is wedged; the ``backend`` and ``runtime`` keys read nothing from
the device either. The per-metric entries read counts back from the
metrics passed in.
"""
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from metrics_tpu_torch.analysis.lockwitness import named_lock

# Known kinds (informative; a subsystem may record a new kind):
#   gather_degraded      a collective fell back to this rank's own state
#   async_sync_error     an overlapped sync cycle raised; readers keep the
#                        previous view and the cadence retries
#   async_sync_stalled   an overlapped sync cycle is in flight past its
#                        deadline; readers keep the previous view
#   forced_cpu           METRICS_TPU_FORCE_CPU is set: CUDA is never touched
#   backend_probe_timeout, backend_probe_failed
#                        the CUDA bootstrap probe (utilities/backend.py) hung
#                        past its deadline or failed
#   snapshot_fallback    a snapshot group failed verification; the restore
#                        fell back to an older one (resilience/snapshot.py)
#   snapshot_mean_approx an elastic restore merged 'mean' states approximately
#   serve_snapshot_error a ServeLoop's periodic snapshot raised
#   drift_detected, drift_recovered, drift_check_error
#                        a DriftMonitor's episode edges and failures (obs/drift.py)
#   drift_baseline_loaded
#                        a DriftMonitor attached a reference (informational)
_MAX_EVENTS = 256

# operational milestones, not degradations: reported and counted, but they
# never set ``degraded``
INFORMATIONAL_EVENT_KINDS = frozenset({"serve_warmup_done", "drift_baseline_loaded"})


class HealthRegistry:
    """Bounded, thread-safe log of the degradations in this process.

    Two stores: a ring of the newest ``max_events`` events (message and
    details), and a table by kind that never evicts (count, first and last
    wall-clock time, last monotonic time), so a degradation stays countable
    however many events came after it."""

    def __init__(self, max_events: int = _MAX_EVENTS) -> None:
        self._lock = named_lock("health.HealthRegistry._lock", threading.Lock(), hot=True)
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=max_events)
        self._kinds: Dict[str, Dict[str, Any]] = {}
        self._listeners: List[Callable[[Dict[str, Any]], None]] = []

    def add_listener(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Register ``fn(event)``, called per recorded event on the
        recording thread, after the ring and table update and outside the
        lock; a raising listener is ignored, never the caller's seam."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def record(self, kind: str, message: str, **details: Any) -> Dict[str, Any]:
        now_unix, now_mono = time.time(), time.monotonic()
        event: Dict[str, Any] = {"kind": kind, "message": message, "time_unix": now_unix, "time_mono": now_mono}
        if details:
            event["details"] = details
        with self._lock:
            self._events.append(event)
            entry = self._kinds.get(kind)
            if entry is None:
                self._kinds[kind] = {"count": 1, "first_unix": now_unix, "last_unix": now_unix, "last_mono": now_mono}
            else:
                entry["count"] += 1
                entry["last_unix"] = now_unix
                entry["last_mono"] = now_mono
        for fn in list(self._listeners):
            try:
                fn(event)
            except Exception:  # noqa: BLE001 - telemetry degrades, never the caller's seam
                pass
        return event

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            events = list(self._events)
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        return events

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {kind: entry["count"] for kind, entry in self._kinds.items()}

    def kinds(self) -> Dict[str, Dict[str, Any]]:
        """The table by kind, which never evicts."""
        with self._lock:
            return {kind: dict(entry) for kind, entry in self._kinds.items()}

    @property
    def degraded(self) -> bool:
        with self._lock:
            return bool(self._kinds)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._kinds.clear()


registry = HealthRegistry()


def record_degradation(kind: str, message: str, **details: Any) -> Dict[str, Any]:
    """Record one degradation event in the process-wide registry."""
    return registry.record(kind, message, **details)


_DEGRADED_KEYS = ("faults", "overflow_dropped")


def _metric_health(metric: Any) -> Dict[str, Any]:
    """One metric's faults, ring overflow, staleness and overlapped-sync
    lag. Staleness and lag are informational: they never set ``degraded``
    (how stale is too stale is the deployment's call)."""
    from metrics_tpu_torch.utilities.guard import INFORMATIONAL_FAULT_CLASSES

    entry: Dict[str, Any] = {}
    faults = getattr(metric, "fault_counts", None)
    if faults:
        nonzero = {k: v for k, v in faults.items() if v and k not in INFORMATIONAL_FAULT_CLASSES}
        if nonzero:
            entry["faults"] = nonzero
        for name in INFORMATIONAL_FAULT_CLASSES:
            if faults.get(name):
                entry[name] = faults[name]
    dropped = getattr(metric, "dropped_count", None)
    if dropped:
        entry["overflow_dropped"] = dropped
    if getattr(metric, "sync_mode", "blocking") == "overlapped":
        lag = getattr(metric, "sync_lag", None)
        if lag is not None:
            entry["sync_mode"] = "overlapped"
            entry["sync_lag_steps"] = lag.get("sync_lag_steps")
            entry["sync_lag_s"] = lag.get("sync_lag_s")
            if lag.get("in_flight"):
                entry["sync_in_flight"] = True
    last = getattr(metric, "_last_update_unix", None)
    if last is not None:
        entry["last_update_unix"] = last
        entry["last_update_step"] = getattr(metric, "update_count", None)
        entry["staleness_s"] = max(0.0, time.time() - last)
    elif hasattr(metric, "_last_update_unix"):
        entry["never_updated"] = True
    return entry


def health_report(*metrics: Any) -> Dict[str, Any]:
    """Every known degradation of this process, as plain data::

        {"backend": {...the CUDA bootstrap state...},
         "events": [...oldest first...],
         "event_counts": {kind: n},
         "event_kinds": {kind: {"count", "first_unix", "last_unix", "last_mono"}},
         "informational_event_kinds": [...],
         "runtime": {"counters": {...}, "histograms": {...}},  # when any
         "metrics": {name: {"faults": {...}, "overflow_dropped": n,
                            "sync_lag_steps": s, "staleness_s": age, ...}},
         "degraded": bool}

    ``metrics`` are ``Metric`` or ``MetricCollection`` instances; a
    collection reports each member under its name, two bare metrics of one
    class as ``Name`` and ``Name#2``. ``degraded`` is True when the
    registry holds an event of a kind that is not informational, or a
    metric reports faults or overflow.
    """
    from metrics_tpu_torch.obs.runtime_metrics import registry as _runtime_registry
    from metrics_tpu_torch.utilities.backend import backend_status

    report: Dict[str, Any] = {
        "backend": backend_status(),
        "events": registry.events(),
        "event_counts": registry.counts(),
        "event_kinds": registry.kinds(),
        "informational_event_kinds": sorted(INFORMATIONAL_EVENT_KINDS),
        "metrics": {},
    }
    # the light self-telemetry summary: counters, histogram counts and sums
    runtime = _runtime_registry.snapshot(quantiles=False)
    if runtime["counters"] or runtime["histograms"]:
        report["runtime"] = runtime
    seen: Dict[str, int] = {}
    for obj in metrics:
        # copy_state=False: a read-only sweep must not copy the groups'
        # shared states or end their aliasing
        members = obj.items(keep_base=True, copy_state=False) if hasattr(obj, "_modules") else [(type(obj).__name__, obj)]
        for name, metric in members:
            entry = _metric_health(metric)
            if entry:
                seen[name] = seen.get(name, 0) + 1
                report["metrics"][name if seen[name] == 1 else f"{name}#{seen[name]}"] = entry
    report["degraded"] = bool(set(report["event_counts"]) - INFORMATIONAL_EVENT_KINDS) or any(
        any(k in entry for k in _DEGRADED_KEYS) for entry in report["metrics"].values()
    )
    return report
