"""Host-side span tracer (counterpart of ``metrics_tpu/obs/trace.py``).

A thread-safe, bounded ring of ``(name, tid, t_start_ns, dur_ns, attrs)``
span records fed by :func:`span` context managers at the port's host
seams (metric update, compute and sync, the overlapped cycle's phases, the
serving loop's offer, update and reduce, snapshot save and restore),
exportable as Chrome/Perfetto trace JSON and read by
``obs/runtime_metrics.py`` (the self-telemetry counters and histograms)
through the sink hook.

Spans wrap host calls that launch device work, never the work itself: a
span around a CUDA graph replay or a kernel launch times the host's launch
and returns, and the tracer never synchronizes the device. A span is taken
inside a captured update's body only as its host code runs during the
capture (``_capture.py``): the replay runs no Python, so it records none.

Causal ids, the env contract and the disabled path are the JAX package's:
enabled spans carry ``trace_id``/``span_id``/``parent_id`` (a span opened
inside another on the same thread is its child; :func:`trace_context`
hands a context to another thread), span ids stay below ``2**52``, and
:func:`clock_sync` pairs the monotonic clock with wall clock for
:func:`merge_chrome_sections`. ``METRICS_TPU_TRACE=1`` turns tracing on
(malformed values warn once and stay off), ``METRICS_TPU_TRACE_BUFFER``
sizes the ring (default 65536 records), and :func:`force_tracing` wins
over the env. Disabled, :func:`span` returns one shared no-op object, with
the enabled check inlined and the env read amortized over 256 calls.

The module imports the standard library, the port's env tools and the
lock witness only. Its locks are the JAX package's named locks
(``analysis/lockwitness.py``).
"""
import contextlib
import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

from metrics_tpu_torch.analysis.lockwitness import named_lock
from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce, bool_token

__all__ = [
    "TraceRecord",
    "TraceContext",
    "span",
    "instant",
    "tracing_enabled",
    "force_tracing",
    "current_context",
    "trace_context",
    "new_trace_id",
    "clock_sync",
    "trace_records",
    "records_since",
    "clear_trace",
    "chrome_trace_events",
    "chrome_events_for",
    "export_chrome_trace",
    "merge_chrome_sections",
    "add_trace_sink",
    "remove_trace_sink",
    "reset_trace_state",
]

_DEFAULT_BUFFER = 65536

_warn_once = WarnOnce()


def _parse_trace(raw: str) -> bool:
    value = bool_token(raw)
    if value is None:
        _warn_once(
            ("trace", raw),
            f"METRICS_TPU_TRACE={raw!r} is not a boolean token (1/0/true/false/"
            "on/off/yes/no); tracing stays disabled.",
        )
        return False
    return value


def _parse_buffer(raw: str) -> int:
    try:
        n = int(raw)
        if n < 1:
            raise ValueError(raw)
        return n
    except ValueError:
        _warn_once(
            ("trace_buffer", raw),
            f"METRICS_TPU_TRACE_BUFFER={raw!r} is not a positive integer; "
            f"using the default ring of {_DEFAULT_BUFFER} records.",
        )
        return _DEFAULT_BUFFER


_ENV_TRACE: "EnvParse[bool]" = EnvParse("METRICS_TPU_TRACE", _parse_trace, False)
_ENV_BUFFER: "EnvParse[int]" = EnvParse("METRICS_TPU_TRACE_BUFFER", _parse_buffer, _DEFAULT_BUFFER)

# programmatic override: True/False force, None defers to the env var
_FORCED: Optional[bool] = None

# the disabled path must price well under 1% of a compiled step, and ONE
# ``os.environ`` read costs ~0.6 µs — so the env resolution is amortized:
# the cached answer serves ``_RECHECK_EVERY`` calls, then the var is
# re-read (flips still land within a bounded, tiny record window; tests
# flip instantly via reset_trace_state()/force_tracing)
_RECHECK_EVERY = 256
_env_enabled = False
_env_countdown = 0


def tracing_enabled() -> bool:
    """Is the tracer recording right now? (programmatic > env > off; the
    env answer is re-read at most every ``_RECHECK_EVERY`` calls)."""
    global _env_enabled, _env_countdown
    if _FORCED is not None:
        return _FORCED
    if _env_countdown > 0:
        _env_countdown -= 1
        return _env_enabled
    _env_countdown = _RECHECK_EVERY
    _env_enabled = _ENV_TRACE()
    return _env_enabled


@contextlib.contextmanager
def force_tracing(enabled: bool) -> Iterator[None]:
    """Scoped programmatic enable/disable — wins over the env var (the
    test/bench/audit hook, mirroring ``ops.dispatch.kernel_override``)."""
    global _FORCED
    prev = _FORCED
    _FORCED = bool(enabled)
    try:
        yield
    finally:
        _FORCED = prev


class TraceRecord(NamedTuple):
    """One completed span (``dur_ns == 0`` marks an instant event).

    ``trace_id``/``span_id``/``parent_id`` are the causal ids (``None`` on
    records written before ids existed, or by a build with ids disabled);
    ``link`` is an optional explicit cross-thread/cross-process causal
    edge ``(trace_id, span_id)`` — the fan-in form parent_id cannot
    express (a reduce covering N publishes links ONE representative
    producer; the exporter renders it as a Perfetto flow arrow).
    ``seq`` is the ring-append sequence number (monotone per process,
    stamped at span EXIT) — the incremental-export cursor. A watermark on
    ``t_start_ns`` would permanently skip any span still OPEN at export
    time (it starts before the watermark but lands in the ring after);
    append order cannot."""

    name: str
    tid: int
    t_start_ns: int
    dur_ns: int
    attrs: Optional[Dict[str, Any]]
    trace_id: Optional[str] = None
    span_id: Optional[int] = None
    parent_id: Optional[int] = None
    link: Optional[Tuple[str, int]] = None
    seq: int = 0


class TraceContext(NamedTuple):
    """The propagatable half of an open span: hand it to another thread
    (``trace_context``) or another process (the fleet wire header
    ``extra["trace"]``) to parent/link later spans under it."""

    trace_id: str
    span_id: int


# span-id allocation: a 20-bit per-process random prefix + a 32-bit counter
# (itertools.count.__next__ is GIL-atomic) — ids are unique across a fleet
# of processes with overwhelming probability AND stay < 2^52, exactly
# representable in the JSON floats trace viewers parse with
_PROC_PREFIX = uuid.uuid4().int & 0xFFFFF
_SPAN_COUNTER = itertools.count(1)
_TRACE_COUNTER = itertools.count(1)
# ring-append sequence (GIL-atomic __next__): stamps TraceRecord.seq so
# incremental exporters cursor on APPEND order, never on start time
_RECORD_SEQ = itertools.count(1)


def _next_span_id() -> int:
    return (_PROC_PREFIX << 32) | (next(_SPAN_COUNTER) & 0xFFFFFFFF)


def new_trace_id() -> str:
    """A fleet-unique trace id (per-process random prefix + counter)."""
    return f"{_PROC_PREFIX:05x}{os.getpid() & 0xFFFF:04x}{next(_TRACE_COUNTER):08x}"


# the thread-local context stack top: each thread sees only ids IT opened
# (or was explicitly handed via trace_context) — no cross-thread leaks
_tls = threading.local()


def current_context() -> Optional[TraceContext]:
    """The innermost open span's context on THIS thread (None outside any
    span, or while tracing is disabled — disabled spans never push)."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def trace_context(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Install ``ctx`` as this thread's ambient trace context (restored on
    exit) — the explicit cross-thread propagation hook: capture
    ``current_context()`` where work is produced, enter it where the work
    is consumed, and the consumer's spans parent under the producer's.
    ``None`` installs "no context" (a span inside starts a fresh trace)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def clock_sync() -> Dict[str, float]:
    """One ``{mono_ns, unix}`` pairing of this process's monotonic clock
    (what span timestamps use) with wall clock — shipped alongside exported
    events so :func:`merge_chrome_sections` can rebase every host's
    timeline onto one shared (unix) timebase; the residual error is each
    host's wall-clock skew, which the fleet merge reports per host as a
    ``clock_offset_estimate`` from publish/receive stamps."""
    return {"mono_ns": time.monotonic_ns(), "unix": time.time()}


# the ring: _ring_lock guards reconfiguration (capacity change / clear)
# and consistent snapshots; the record path takes only _append_lock — a
# tiny critical section making seq allocation + append ONE step, so seq
# order IS append order and an incremental-export cursor can never commit
# past a record whose seq was allocated but not yet appended
_ring_lock = named_lock("trace._ring_lock", threading.Lock(), hot=True)
_append_lock = named_lock("trace._append_lock", threading.Lock(), hot=True)
_ring: "deque[TraceRecord]" = deque(maxlen=_DEFAULT_BUFFER)

# populated at import: obs/__init__.py imports runtime_metrics, whose
# module bottom registers the self-telemetry sink (and importing any obs
# submodule initializes the package first, so the sink is always wired
# before a record can exist)
_SINKS: List[Callable[[str, int, Optional[Dict[str, Any]]], None]] = []


# capacity resolves lazily: at the first record after import or
# reset_trace_state() (not per record — that would be another environ read
# on the hot path); a changed knob takes effect at the next reset
_ring_dirty = True


def _current_ring() -> "deque[TraceRecord]":
    """The ring at the configured capacity; resized (newest records kept)
    when the buffer knob changed since the last ``reset_trace_state``."""
    global _ring, _ring_dirty
    if _ring_dirty:
        with _ring_lock:
            _ring_dirty = False
            cap = _ENV_BUFFER()
            if _ring.maxlen != cap:
                _ring = deque(_ring, maxlen=cap)
    return _ring


# tid -> thread name, captured at the first record from each thread (the
# dict-membership check is the only per-record cost) so exported traces
# carry real thread_name metadata instead of bare integer tids
_TID_NAMES: Dict[int, str] = {}


def _record(
    name: str,
    t_start_ns: int,
    dur_ns: int,
    attrs: Optional[Dict[str, Any]],
    trace_id: Optional[str] = None,
    span_id: Optional[int] = None,
    parent_id: Optional[int] = None,
    link: Optional[Tuple[str, int]] = None,
) -> None:
    tid = threading.get_ident()
    if tid not in _TID_NAMES:
        _TID_NAMES[tid] = threading.current_thread().name
    ring = _current_ring()
    with _append_lock:
        ring.append(
            TraceRecord(
                name,
                tid,
                t_start_ns,
                dur_ns,
                attrs,
                trace_id,
                span_id,
                parent_id,
                link,
                next(_RECORD_SEQ),
            )
        )
    for sink in _SINKS:
        try:
            sink(name, dur_ns, attrs)
        except Exception as err:  # noqa: BLE001 — telemetry degrades, never breaks the seam
            _warn_once(
                ("sink", type(err).__name__),
                f"trace sink {getattr(sink, '__name__', sink)!r} raised "
                f"{type(err).__name__}: {err}; its records are dropped",
            )


class _LiveSpan:
    __slots__ = ("name", "attrs", "link", "_t0", "_prev", "trace_id", "span_id", "parent_id")

    def __init__(
        self,
        name: str,
        attrs: Optional[Dict[str, Any]],
        link: Optional[TraceContext] = None,
    ) -> None:
        self.name = name
        self.attrs = attrs
        self.link = link

    def __enter__(self) -> "_LiveSpan":
        ctx = getattr(_tls, "ctx", None)
        self.span_id = _next_span_id()
        if ctx is not None:
            self.trace_id = ctx.trace_id
            self.parent_id = ctx.span_id
        else:
            self.trace_id = self.link.trace_id if self.link is not None else new_trace_id()
            self.parent_id = None
        self._prev = ctx
        _tls.ctx = TraceContext(self.trace_id, self.span_id)
        self._t0 = time.monotonic_ns()
        return self

    def set(self, **attrs: Any) -> None:
        """Attach attrs discovered mid-span (e.g. the padding tier a batch
        resolved to) — recorded with the span at exit."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __exit__(self, *exc: Any) -> bool:
        t0 = self._t0
        dur = time.monotonic_ns() - t0
        _tls.ctx = self._prev
        _record(
            self.name,
            t0,
            dur,
            self.attrs,
            trace_id=self.trace_id,
            span_id=self.span_id,
            parent_id=self.parent_id,
            link=tuple(self.link) if self.link is not None else None,
        )
        return False


class _NoopSpan:
    """The disabled path: one shared instance, enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def set(self, **attrs: Any) -> None:
        pass

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


def span(name: str, /, link_to: Optional[TraceContext] = None, **attrs: Any):
    """Context manager timing one host-side seam. Disabled → the shared
    no-op singleton (zero record-path allocation). ``name`` is
    positional-only so an attr may also be called ``name``; ``link_to`` is
    the one reserved kwarg — a :class:`TraceContext` this span causally
    descends from across a thread/process boundary (fan-in seams), drawn
    as a Perfetto flow arrow by the exporter."""
    # the enabled check is inlined (one function call saved per span —
    # these sit on every metric update)
    global _env_enabled, _env_countdown
    if _FORCED is None:
        if _env_countdown > 0:
            _env_countdown -= 1
            enabled = _env_enabled
        else:
            _env_countdown = _RECHECK_EVERY
            enabled = _env_enabled = _ENV_TRACE()
    else:
        enabled = _FORCED
    if not enabled:
        return _NOOP_SPAN
    return _LiveSpan(name, attrs or None, link=link_to)


def instant(name: str, /, **attrs: Any) -> None:
    """Record a point event (``dur_ns == 0``) — occurrence counting:
    retrace events, dispatch decisions, coalesced triggers. Inherits the
    thread's ambient trace context (parented under the open span)."""
    if not tracing_enabled():
        return
    ctx = getattr(_tls, "ctx", None)
    _record(
        name,
        time.monotonic_ns(),
        0,
        attrs or None,
        trace_id=ctx.trace_id if ctx is not None else None,
        span_id=_next_span_id(),
        parent_id=ctx.span_id if ctx is not None else None,
    )


# -- readers / export ------------------------------------------------------


def trace_records(name: Optional[str] = None) -> List[TraceRecord]:
    """A consistent snapshot of the ring, oldest first."""
    with _ring_lock:
        records = list(_ring)
    if name is not None:
        records = [r for r in records if r.name == name]
    return records


def records_since(seq: int) -> List[TraceRecord]:
    """Records APPENDED after sequence number ``seq`` — the
    incremental-export cursor the fleet publisher ships deltas with (pair
    with the newest record's ``seq`` as the next watermark). Cursoring on
    append order, not ``t_start_ns``, means a span that was still open at
    the previous export (started before it, closed after) ships with the
    next delta instead of being skipped forever.

    Cost is O(delta), not O(ring): seq allocation + append are one step
    under ``_append_lock``, so ring order is exactly seq order and the
    reverse scan stops at the first already-shipped record."""
    with _ring_lock:
        snap = list(_ring)  # one C-level copy; the scan runs lock-free
    out: List[TraceRecord] = []
    for r in reversed(snap):
        if r.seq <= seq:
            break
        out.append(r)
    out.reverse()
    return out


def clear_trace() -> None:
    with _ring_lock:
        _ring.clear()


def chrome_events_for(
    records: List[TraceRecord], host_id: Optional[str] = None, pid: Optional[int] = None
) -> List[Dict[str, Any]]:
    """``records`` as Chrome/Perfetto trace events (the reusable core of
    :func:`chrome_trace_events` — the fleet publisher renders incremental
    record batches through it). Emits, in order: ``M`` metadata rows
    (process/thread names), the span/instant events themselves (causal ids
    in ``args``), and the causal flow arrows — a ``ph='s'`` flow start
    bound at each identified span plus a ``ph='f'`` (bind-to-enclosing)
    finish at each span that has a ``parent_id`` or an explicit ``link``,
    keyed on the fleet-unique span ids so arrows survive a cross-process
    merge."""
    pid = os.getpid() if pid is None else pid
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": host_id or f"metrics_tpu pid {pid}"},
        }
    ]
    for tid in sorted({r.tid for r in records}):
        name = _TID_NAMES.get(tid)
        if name:
            events.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": name}}
            )
    flows: List[Dict[str, Any]] = []
    for rec in records:
        ts = rec.t_start_ns / 1e3
        event: Dict[str, Any] = {"name": rec.name, "pid": pid, "tid": rec.tid, "ts": ts}
        if rec.dur_ns:
            event["ph"] = "X"
            event["dur"] = rec.dur_ns / 1e3
        else:
            event["ph"] = "i"
            event["s"] = "t"  # thread-scoped instant
        args: Dict[str, Any] = dict(rec.attrs) if rec.attrs else {}
        if rec.trace_id is not None:
            args["trace_id"] = rec.trace_id
            args["span_id"] = rec.span_id
            if rec.parent_id is not None:
                args["parent_id"] = rec.parent_id
        if args:
            event["args"] = args
        events.append(event)
        if rec.span_id is None:
            continue
        if rec.dur_ns:
            # a flow START bound inside this span (at its start, so the
            # arrow runs forward in time to nested children AND to
            # later cross-process descendants): descendants draw FROM here
            flows.append(
                {
                    "name": "causal",
                    "cat": "causal",
                    "ph": "s",
                    "id": rec.span_id,
                    "pid": pid,
                    "tid": rec.tid,
                    "ts": ts,
                }
            )
        for origin in (rec.parent_id, rec.link[1] if rec.link else None):
            if origin is None:
                continue
            flows.append(
                {
                    "name": "causal",
                    "cat": "causal",
                    "ph": "f",
                    "bp": "e",  # bind to the enclosing slice
                    "id": origin,
                    "pid": pid,
                    "tid": rec.tid,
                    "ts": ts,
                }
            )
    return events + flows


def chrome_trace_events(host_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """The ring as Chrome/Perfetto trace events: ``M`` metadata rows first
    (``process_name`` = ``host_id`` or ``metrics_tpu pid N``, one
    ``thread_name`` per seen tid — merged fleet traces read as named
    processes/threads instead of bare integers), then ``ph='X'`` complete
    spans / ``ph='i'`` instants (timestamps/durations in microseconds),
    then the causal flow arrows (``ph='s'``/``'f'`` pairs keyed on span
    ids) for every parented or linked span."""
    return chrome_events_for(trace_records(), host_id=host_id)


def export_chrome_trace(path: Optional[str] = None, host_id: Optional[str] = None) -> str:
    """The ring as a Chrome/Perfetto-loadable JSON document; optionally
    written to ``path`` (load via ``chrome://tracing`` or ui.perfetto.dev).
    The write rides ``atomic_write_bytes`` (GL502): an export raced by a
    crash or a second exporter must never leave a half-JSON file for the
    trace-merge tooling to choke on."""
    doc = json.dumps(
        {"traceEvents": chrome_trace_events(host_id=host_id), "displayTimeUnit": "ms"}
    )
    if path is not None:
        from metrics_tpu_torch.resilience.snapshot import atomic_write_bytes

        atomic_write_bytes(path, doc.encode("utf-8"))
    return doc


def merge_chrome_sections(sections: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-host event sections into ONE Perfetto-loadable document.

    Each section is ``{"host_id": str, "clock": clock_sync() output,
    "events": [chrome events]}`` (what the fleet publisher ships in the
    wire header ``extra["trace"]``, accumulated per host by the
    aggregator). Every section's span timestamps are monotonic-clock-local
    to its process; the merge rebases them onto the section's wall clock
    (``ts_unix_us = ts - mono_ns/1e3 + unix*1e6``) so the hosts share one
    timebase, and assigns each host a synthetic ``pid`` (+ a
    ``process_name`` metadata row naming it). Flow arrows (span ids are
    fleet-unique) survive the merge, so a cross-process link renders as an
    arrow between two hosts' tracks. Sections may carry an optional
    ``clock_offset_estimate`` (seconds, receiver-measured) — recorded as a
    process metadata arg for skew diagnosis, never silently applied (it is
    contaminated by one-way network latency)."""
    events: List[Dict[str, Any]] = []
    for pid, section in enumerate(sections, start=1):
        host = section.get("host_id") or f"section-{pid}"
        clock = section.get("clock") or {}
        shift_us = None
        if "mono_ns" in clock and "unix" in clock:
            shift_us = clock["unix"] * 1e6 - clock["mono_ns"] / 1e3
        meta_args: Dict[str, Any] = {"name": host}
        if section.get("clock_offset_estimate") is not None:
            meta_args["clock_offset_estimate_s"] = section["clock_offset_estimate"]
        events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "args": meta_args}
        )
        for ev in section.get("events") or []:
            out = dict(ev)
            out["pid"] = pid
            if shift_us is not None and "ts" in out and out.get("ph") != "M":
                out["ts"] = out["ts"] + shift_us
            events.append(out)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- sinks -----------------------------------------------------------------


def add_trace_sink(sink: Callable[[str, int, Optional[Dict[str, Any]]], None]) -> None:
    """Register ``sink(name, dur_ns, attrs)``, called per completed record.
    Sinks run on the instrumented thread — they must be cheap; a raising
    sink warns once and its records are dropped, never the caller's work."""
    if sink not in _SINKS:
        _SINKS.append(sink)


def remove_trace_sink(sink: Callable[[str, int, Optional[Dict[str, Any]]], None]) -> None:
    if sink in _SINKS:
        _SINKS.remove(sink)


def reset_trace_state() -> None:
    """Test hook: clear the ring, the forced mode, warn-once memory, the
    memoized env parses, and the CALLING thread's trace context (other
    threads' contexts die with their spans); the next enablement check and
    record re-read the env."""
    global _FORCED, _env_enabled, _env_countdown, _ring_dirty
    _FORCED = None
    _env_enabled = False
    _env_countdown = 0
    _ring_dirty = True
    _tls.ctx = None
    _TID_NAMES.clear()
    _warn_once.reset()
    _ENV_TRACE.reset()
    _ENV_BUFFER.reset()
    clear_trace()
