"""The overlapped sync scheduler: double-buffered reduced views
(counterpart of ``metrics_tpu/parallel/async_sync.py``).

A blocking sync makes ``compute()`` pay the whole collective. The
overlapped mode issues the collective early, against a snapshot of the
live state, on a worker thread, while the live state keeps absorbing
updates; ``compute()`` then reads the already-reduced result.

:class:`AsyncSyncScheduler` is that mechanism: after each update the
producer calls :meth:`~AsyncSyncScheduler.notify`; on the cadence
(``sync_every_n`` updates and/or ``sync_every_s`` seconds) the worker takes
a snapshot, reduces it and publishes an immutable :class:`SyncView`.
``Metric(sync_mode="overlapped")`` and ``MetricCollection`` consume it.

Degradation: a cycle whose reduce raises keeps the previous view and
reports through ``on_error`` (an ``async_sync_error`` health event);
readers keep the old view, loudly stale, and the next cadence retries. A
cycle in flight past ``deadline_s`` records ``async_sync_stalled`` once per
episode when a reader sees it. The hang of a collective itself is bounded
by ``parallel/sync.py::RetryingGather``.

A view is published into one slot under a condition lock: a reader sees
the whole previous view or the whole next one. Sequences of collectives
(a cycle's reduce, a blocking sync) hold
``parallel/sync.py::gather_sequence_lock``, so within a process they
serialize. Across processes they must pair: the update cadence and
:meth:`AsyncSyncScheduler.request` snapshot at the trigger and queue one
cycle each (the JAX package snapshots on the worker and merges the
triggers that arrive during a cycle, so its number of cycles depends on
timing; a stated difference), so ranks of an SPMD update stream issue the
same cycles, each over the state of the same step. A blocking sync on
another thread while cycles run is on the caller, as in the JAX package.

Cadence from the environment (malformed values warn once and keep the
default): ``METRICS_TPU_SYNC_EVERY_N`` (default 1: a cycle after every
update) and ``METRICS_TPU_SYNC_EVERY_S`` (default unset). ``tick_fn`` is
side work on every wake of the worker (a serving loop's periodic snapshots
and drift checks), returning the seconds until it is next due.

Traced seams (``obs/trace.py``): ``async_sync.snapshot`` around each
snapshot (on the producer's thread for an update-cadence trigger),
``async_sync.cycle`` around each reduce and publish on the worker, with
``async_sync.reduce`` and ``async_sync.publish`` inside it.
"""
import atexit
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, NamedTuple, Optional, Tuple

from metrics_tpu_torch.analysis.lockwitness import named_lock
from metrics_tpu_torch.obs import trace as _obs_trace
from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce

__all__ = ["AsyncSyncScheduler", "SyncView", "resolve_sync_cadence", "reset_async_sync_state"]

_warn_once = WarnOnce()

# live schedulers, stopped when the interpreter exits: a daemon thread that
# is still inside a torch call when the interpreter finalizes aborts the
# process ("terminate called without an active exception")
_LIVE: "weakref.WeakSet" = weakref.WeakSet()
_EXIT_JOIN_S = 10.0
# snapshots that may wait for the worker; a further trigger blocks until it
# takes one (bounded memory without dropping a cycle, which would unpair the
# ranks)
_MAX_PENDING = 2


@atexit.register
def _stop_all_at_exit() -> None:
    for sched in list(_LIVE):
        sched.stop(final=False, timeout_s=_EXIT_JOIN_S)


def _parse_every_n(raw: str) -> Optional[int]:
    try:
        n = int(raw)
        if n < 1:
            raise ValueError(raw)
        return n
    except ValueError:
        _warn_once(
            ("sync_every_n", raw),
            f"METRICS_TPU_SYNC_EVERY_N={raw!r} is not a positive integer; "
            "falling back to the default cadence (sync every update).",
        )
        return None


def _parse_every_s(raw: str) -> Optional[float]:
    try:
        s = float(raw)
        if s <= 0:
            raise ValueError(raw)
        return s
    except ValueError:
        _warn_once(
            ("sync_every_s", raw),
            f"METRICS_TPU_SYNC_EVERY_S={raw!r} is not a positive number; ignoring the time cadence.",
        )
        return None


_ENV_EVERY_N: EnvParse = EnvParse("METRICS_TPU_SYNC_EVERY_N", _parse_every_n, None)
_ENV_EVERY_S: EnvParse = EnvParse("METRICS_TPU_SYNC_EVERY_S", _parse_every_s, None)


def resolve_sync_cadence(
    sync_every_n: Optional[int], sync_every_s: Optional[float]
) -> Tuple[Optional[int], Optional[float]]:
    """The arguments, else the variables, else a cycle after every update:
    ``(every_n, every_s)``, ``every_n`` 1 when neither source sets a
    cadence (an overlapped metric without one would never sync)."""
    n = sync_every_n if sync_every_n is not None else _ENV_EVERY_N()
    s = sync_every_s if sync_every_s is not None else _ENV_EVERY_S()
    if n is not None and n < 1:
        raise ValueError(f"`sync_every_n` must be >= 1, got {n}")
    if s is not None and s <= 0:
        raise ValueError(f"`sync_every_s` must be > 0, got {s}")
    if n is None and s is None:
        n = 1
    return n, s


def reset_async_sync_state() -> None:
    """Forget the memoized variables and the warn-once memory."""
    _warn_once.reset()
    _ENV_EVERY_N.reset()
    _ENV_EVERY_S.reset()


class SyncView(NamedTuple):
    """One completed cycle: the reduced payload and what it covers.

    ``covered_seq`` is the notify count read before the snapshot, a lower
    bound of what the payload covers; ``covered_steps`` the producer's own
    step count at the snapshot (a metric's update count), against which
    ``sync_lag_steps`` is measured."""

    payload: Any
    covered_seq: int
    covered_steps: int
    snapshot_unix: float
    completed_unix: float


class AsyncSyncScheduler:
    """A background reducer: snapshot, reduce, publish.

    ``snapshot_fn() -> (payload, steps)`` captures the live state (the
    producer guards its own swaps); ``reduce_fn(payload) -> reduced`` runs
    the collectives on the worker thread. The last completed cycle is the
    front buffer (:meth:`view`), so readers never wait on a collective.

    Cycles pair across processes: every ``sync_every_n``-th :meth:`notify`
    and every :meth:`request` takes its snapshot at once, on the calling
    thread, and queues it; the worker reduces the queue in order, one cycle
    per snapshot, never merging two. Ranks that notify in the same order (an
    SPMD update stream) so issue the same cycles, each over the state of one
    and the same step. At most two snapshots wait; a further trigger blocks
    until the worker takes one. The time cadence
    (``sync_every_s``) and the final cycle of :meth:`stop` snapshot on the
    worker instead, when notifies are left uncovered: their cycles depend
    on timing, so a multi-process world should rely on the update cadence
    and :meth:`request` (a cycle that one process issues alone is bounded by
    the communicator's timeout).
    """

    def __init__(
        self,
        snapshot_fn: Callable[[], Tuple[Any, Optional[int]]],
        reduce_fn: Callable[[Any], Any],
        *,
        sync_every_n: Optional[int] = 1,
        sync_every_s: Optional[float] = None,
        deadline_s: float = 120.0,
        tick_fn: Optional[Callable[[], Optional[float]]] = None,
        on_error: Optional[Callable[[BaseException], None]] = None,
        name: str = "metric",
    ) -> None:
        self.snapshot_fn = snapshot_fn
        self.reduce_fn = reduce_fn
        self.sync_every_n = sync_every_n
        self.sync_every_s = sync_every_s
        self.deadline_s = float(deadline_s)
        # side work on the worker's every wake (a serving loop's snapshots
        # and drift checks): returns the seconds until it is next due, or
        # None, and the worker's wait wakes for it
        self.tick_fn = tick_fn
        self._tick_due: Optional[float] = None
        self._last_cycle_seq = 0
        self.on_error = on_error
        self.name = name

        self._lock = named_lock("async_sync._lock", threading.Lock(), hot=True)
        self._seq = 0  # notifies so far: the unit of coverage
        self._steps = 0  # the producer's step count at the last notify
        self._trigger_seq = 0  # seq of the last update-cadence trigger
        self._covered = -1  # seq covered by the front view (written by the worker only)
        self._skip_final = False
        self._last_attempt_mono = time.monotonic()
        self._in_flight_since: Optional[float] = None
        self._stall_reported = False

        self._cv = named_lock("async_sync._cv", threading.Condition(), hot=True)
        self._pending: "deque" = deque()  # (seq, payload, steps, snapshot_unix), in trigger order
        self._inflight_seq: Optional[int] = None  # the seq of the cycle being reduced
        self._view: Optional[SyncView] = None
        self._stopped = False
        # what the cycles cost: completed cycles, their seconds, and the
        # seconds producers waited for room in the queue
        self.cycles = 0
        self.cycle_s = 0.0
        self.blocked_s = 0.0

        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=f"metrics-tpu-async-sync-{name}")
        self._thread.start()
        _LIVE.add(self)

    # -- producer side --------------------------------------------------

    def notify(self, steps: Optional[int] = None) -> None:
        """One mutation of the live state. On every ``sync_every_n``-th, a
        snapshot is queued for a cycle."""
        with self._lock:
            self._seq += 1
            self._steps = steps if steps is not None else self._seq
            due = self.sync_every_n is not None and (self._seq - self._trigger_seq) >= self.sync_every_n
            if due:
                self._trigger_seq = self._seq
            seq = self._seq
        if due:
            self._enqueue(seq)

    def request(self) -> None:
        """Queue a cycle over the state as it is now, whatever the cadence."""
        self._enqueue(self.seq())

    def seq(self) -> int:
        """The notify count (pair with :meth:`wait_covered`)."""
        with self._lock:
            return self._seq

    def _enqueue(self, seq: int) -> None:
        """Snapshot on this thread and queue the cycle (blocking while
        ``_MAX_PENDING`` snapshots wait)."""
        if self._stopped:
            return
        snapshot_unix = time.time()
        try:
            with _obs_trace.span("async_sync.snapshot", name=self.name):
                payload, steps = self.snapshot_fn()
        except Exception as err:  # noqa: BLE001 — a failed snapshot keeps the stale view
            if self.on_error is not None:
                self.on_error(err)
            return
        with self._cv:
            t0 = time.perf_counter()
            self._cv.wait_for(lambda: len(self._pending) < _MAX_PENDING or self._stopped)
            self.blocked_s += time.perf_counter() - t0
            if self._stopped:
                return
            self._pending.append((seq, payload, seq if steps is None else steps, snapshot_unix))
        self._wake.set()

    # -- reader side ----------------------------------------------------

    def view(self) -> Optional[SyncView]:
        """The front buffer, the last completed cycle (None before the
        first). Never blocks."""
        self._check_stalled()
        return self._view

    def covered(self, target_seq: Optional[int] = None) -> bool:
        with self._cv:
            target = self._seq if target_seq is None else target_seq
            return self._view is not None and self._covered >= target

    def wait_covered(self, target_seq: int, deadline_s: float) -> bool:
        """Block, at most ``deadline_s``, until the front view covers
        ``target_seq``, queueing a cycle when none queued covers it. False on
        the deadline, or when the scheduler stopped with the target
        uncovered."""
        def cov() -> bool:
            return self._view is not None and self._covered >= target_seq

        with self._cv:
            if cov():
                return True
            if self._stopped:
                return False
            queued = self._queued_covers(target_seq)
        if not queued:
            self.request()
        with self._cv:
            self._cv.wait_for(lambda: cov() or self._stopped, timeout=max(0.0, deadline_s))
            return cov()

    def lag(self, live_steps: Optional[int] = None) -> dict:
        """How far the front view trails the live state."""
        self._check_stalled()
        view = self._view
        with self._lock:
            steps = self._steps if live_steps is None else live_steps
            in_flight = self._in_flight_since is not None
        if view is None:
            return {"sync_lag_steps": steps, "sync_lag_s": None, "synced_once": False, "in_flight": in_flight}
        return {
            "sync_lag_steps": max(0, steps - view.covered_steps),
            "sync_lag_s": max(0.0, time.time() - view.snapshot_unix),
            "synced_once": True,
            "in_flight": in_flight,
        }

    @property
    def stopped(self) -> bool:
        return self._stopped

    def _check_stalled(self) -> None:
        """A cycle in flight past its deadline is recorded once per episode
        when a reader sees it; readers keep the previous view."""
        with self._lock:
            since = self._in_flight_since
            if since is None or self._stall_reported:
                return
            if time.monotonic() - since - self.deadline_s <= 0:
                return
            self._stall_reported = True
        from metrics_tpu_torch.resilience.health import record_degradation

        record_degradation(
            "async_sync_stalled",
            f"overlapped sync cycle for {self.name} in flight past its {self.deadline_s:.0f}s deadline; "
            "readers are serving the previous reduced view (growing staleness)",
            name=self.name,
        )

    # -- worker ---------------------------------------------------------

    def _wait_timeout(self) -> Optional[float]:
        waits = []
        if self.sync_every_s is not None:
            waits.append(max(0.0, self._last_attempt_mono + self.sync_every_s - time.monotonic()))
        if self.tick_fn is not None and self._tick_due is not None:
            waits.append(max(0.0, self._tick_due))
        return min(waits) if waits else None

    def _tick(self) -> None:
        """The side work of one wake; a failure degrades, never stops the
        worker."""
        if self.tick_fn is None:
            return
        try:
            self._tick_due = self.tick_fn()
        except Exception as err:  # noqa: BLE001 — side work degrades, never kills the loop
            self._tick_due = None
            if self.on_error is not None:
                self.on_error(err)

    def _queued_covers(self, seq: int) -> bool:
        """A queued or running cycle covers ``seq`` (the caller holds
        ``_cv``)."""
        return any(item[0] >= seq for item in self._pending) or (self._inflight_seq is not None and self._inflight_seq >= seq)

    def _drain(self) -> None:
        """Reduce the queued snapshots, in order."""
        while True:
            with self._cv:
                if not self._pending or self._skip_final:
                    return
                item = self._pending.popleft()
                self._inflight_seq = item[0]
                self._cv.notify_all()  # a producer may wait for room
            self._cycle(*item)

    def _worker_cycle(self) -> None:
        """A cycle snapshotted here, when notifies are left uncovered (the
        time cadence, the final pass)."""
        with self._lock:
            seq, skip = self._seq, self._skip_final
        with self._cv:
            if seq == self._covered or skip or self._queued_covers(seq):
                return
            self._inflight_seq = seq
        snapshot_unix = time.time()
        try:
            with _obs_trace.span("async_sync.snapshot", name=self.name):
                payload, steps = self.snapshot_fn()
        except Exception as err:  # noqa: BLE001 — a failed snapshot keeps the stale view
            if self.on_error is not None:
                self.on_error(err)
            return
        self._cycle(seq, payload, seq if steps is None else steps, snapshot_unix)

    def _loop(self) -> None:
        # learn the side work's cadence first (a tick with nothing due
        # returns its due-in), so the first wait is not a spurious wake
        self._tick()
        while True:
            if self._wake.wait(timeout=self._wait_timeout()):
                self._wake.clear()
            self._drain()
            if self.sync_every_s is not None and time.monotonic() - self._last_attempt_mono >= self.sync_every_s:
                # the cadence's base moves on idle wakeups too, or the wait
                # of a quiet scheduler would fall to 0 and spin
                self._last_attempt_mono = time.monotonic()
                self._worker_cycle()
            self._tick()
            if self._stop_evt.is_set():
                # a last cycle so the view covers everything, unless
                # stop(final=False) waived it
                self._drain()
                self._worker_cycle()
                with self._cv:
                    self._stopped = True
                    self._pending.clear()
                    self._cv.notify_all()
                return

    def _cycle(self, seq: int, payload: Any, steps: int, snapshot_unix: float) -> None:
        """One reduce and publish of a snapshot taken at notify ``seq``."""
        with self._lock:
            self._in_flight_since = time.monotonic()
            self._stall_reported = False
        self._last_attempt_mono = time.monotonic()
        t0 = time.perf_counter()
        # notifies covered by this cycle beyond the previous one's
        coalesced = seq - self._last_cycle_seq
        self._last_cycle_seq = seq
        with _obs_trace.span("async_sync.cycle", name=self.name, coalesced=coalesced, seq=seq):
            try:
                with _obs_trace.span("async_sync.reduce", name=self.name):
                    reduced = self.reduce_fn(payload)
            except Exception as err:  # noqa: BLE001 — a failed cycle keeps the stale view
                self._end_cycle(None)
                if self.on_error is not None:
                    self.on_error(err)
                return  # coverage not advanced: a later trigger retries
            self.cycles += 1
            self.cycle_s += time.perf_counter() - t0
            with _obs_trace.span("async_sync.publish", name=self.name):
                self._end_cycle(
                    SyncView(payload=reduced, covered_seq=seq, covered_steps=steps, snapshot_unix=snapshot_unix, completed_unix=time.time())
                )

    def _end_cycle(self, view: Optional[SyncView]) -> None:
        """Publish ``view`` (None: the cycle failed), in one step with the
        end of the cycle, so a waiter never sees neither."""
        with self._lock:
            self._in_flight_since = None
        with self._cv:
            if view is not None and view.covered_seq >= self._covered:
                self._view = view
                self._covered = view.covered_seq
            self._inflight_seq = None
            self._cv.notify_all()

    # -- lifecycle ------------------------------------------------------

    def stop(self, final: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the worker; with ``final=True`` it reduces what is queued and
        runs one last cycle, so the front view covers every notify."""
        if not final:
            with self._lock:
                self._skip_final = True
        self._stop_evt.set()
        self._wake.set()
        self._thread.join(timeout=timeout_s)
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
