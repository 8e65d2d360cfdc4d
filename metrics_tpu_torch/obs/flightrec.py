"""Degradation flight recorder (counterpart of
``metrics_tpu/obs/flightrec.py``): a bounded black box for post-mortems.

On every degraded-edge health transition (a non-informational
:class:`~metrics_tpu_torch.resilience.health.HealthRegistry` event, at most
once per kind per ``min_interval_s``) and at SIGTERM or exit, it dumps
atomically:

- the newest span records (``obs/trace.py``, causal ids included),
- the never-evicting event-kind table and the bounded event ring,
- the last scrape (the Prometheus text a scraper would have read),
- every attached source's state (a ``ServeLoop`` attaches its host view:
  serving, warmup, sync and drift state),

to a rolling last-K directory through ``resilience/snapshot.py``'s
:func:`atomic_write_bytes`, each file carrying a magic string, a schema
version and a sha256 over the payload, so :func:`load_flight_records`
skips a torn or bit-flipped survivor loudly and keeps reading the intact
ones. The file format is the JAX package's.

**The exit hooks never touch CUDA.** A source's provider returns host data
(a device state a provider wants to show is read back before the dump, as
the serving loop's reducer does with its fault counts), and the exit dump
renders its scrape under :func:`~metrics_tpu_torch.obs.runtime_metrics.host_only_reads`:
no synchronize and no read-back inside a signal handler or at interpreter
exit. A degraded-edge dump runs on a background thread and may read a
histogram's sketch back, as a scrape does.

``METRICS_TPU_FLIGHTREC_DIR`` arms it (unset: disabled; unusable: warns
once and stays disabled), ``METRICS_TPU_FLIGHTREC_KEEP`` bounds the window
(default 8 dumps per process), :func:`install_flight_recorder` wins over
the env. Its locks are the JAX package's named locks, and the JSON dump is
a blocking seam of the lock witness (``analysis/lockwitness.py``), as in
the JAX package.
"""
import atexit
import hashlib
import json
import os
import re
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from metrics_tpu_torch.analysis.lockwitness import named_lock, note_blocking
from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce
from metrics_tpu_torch.resilience.health import INFORMATIONAL_EVENT_KINDS
from metrics_tpu_torch.resilience.health import registry as _health_registry
from metrics_tpu_torch.resilience.snapshot import atomic_write_bytes

__all__ = [
    "MAGIC",
    "SCHEMA_VERSION",
    "FlightRecorder",
    "FlightRecordError",
    "install_flight_recorder",
    "active_flight_recorder",
    "attach_source",
    "detach_source",
    "load_flight_record",
    "load_flight_records",
    "reset_flightrec_state",
]

MAGIC = "metrics-tpu-flightrec"
SCHEMA_VERSION = 1

_DIR_ENV = "METRICS_TPU_FLIGHTREC_DIR"
_KEEP_ENV = "METRICS_TPU_FLIGHTREC_KEEP"
_DEFAULT_KEEP = 8
# one dump per kind per episode: repeats of an already-dumped kind inside
# this window are the same incident still unfolding, not a new one
_DEFAULT_MIN_INTERVAL_S = 30.0
_SPANS_CAP = 4096  # newest span records per dump (the ring can hold 65536)
# the reasons of the process-exit dump, whose scrape reads nothing from the card
_EXIT_REASONS = ("atexit", "sigterm")

# pid in the name: two processes sharing one dump directory (one env var
# per node) must never collide on a filename — an identical-ms dump from a
# sibling would silently os.replace the one black box that mattered
_FILE_RE = re.compile(
    r"^flightrec\.(?P<ms>\d+)\.(?P<pid>\d+)\.(?P<seq>\d+)\.(?P<kind>[A-Za-z0-9_-]+)\.json$"
)

_warn_once = WarnOnce()


class FlightRecordError(RuntimeError):
    """A flight-recorder dump failed verification (torn write, bit flip,
    newer schema) — named, never silently half-loaded."""


def _parse_keep(raw: str) -> int:
    try:
        n = int(raw)
        if n < 1:
            raise ValueError(raw)
        return n
    except ValueError:
        _warn_once(
            ("flightrec-keep", raw),
            f"{_KEEP_ENV}={raw!r} is not a positive integer; keeping the default "
            f"rolling window of {_DEFAULT_KEEP} dumps.",
        )
        return _DEFAULT_KEEP


_ENV_DIR: "EnvParse[Optional[str]]" = EnvParse(_DIR_ENV, lambda raw: raw, None)
_ENV_KEEP: "EnvParse[int]" = EnvParse(_KEEP_ENV, _parse_keep, _DEFAULT_KEEP)


# --------------------------------------------------------------------------
# attached sources: live-state providers the dump snapshots (module-level so
# a ServeLoop registers once and whichever recorder is active reads it)
# --------------------------------------------------------------------------

_sources_lock = named_lock("flightrec._sources_lock", threading.Lock(), hot=True)
_SOURCES: Dict[str, Callable[[], Any]] = {}
_source_seq = 0


def attach_source(name: str, provider: Callable[[], Any]) -> str:
    """Register ``provider()`` (a JSON-able state snapshot — e.g.
    ``ServeLoop``'s host view) under ``name``; every dump calls it and records
    the result (or the error string — a raising provider degrades to a
    note, never kills the dump). Returns the token to :func:`detach_source`
    with (names are suffixed on collision, so two loops of one metric class
    both stay visible)."""
    global _source_seq
    with _sources_lock:
        _source_seq += 1
        token = name if name not in _SOURCES else f"{name}#{_source_seq}"
        _SOURCES[token] = provider
        return token


def detach_source(token: str) -> None:
    with _sources_lock:
        _SOURCES.pop(token, None)


def _snapshot_sources() -> Dict[str, Any]:
    with _sources_lock:
        providers = dict(_SOURCES)
    out: Dict[str, Any] = {}
    for name, provider in providers.items():
        try:
            out[name] = provider()
        except Exception as err:  # noqa: BLE001 — a dead source is a data point, not a dump failure
            out[name] = {"error": f"{type(err).__name__}: {err}"}
    return out


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------


def _payload_digest(payload: Dict[str, Any]) -> str:
    canonical = json.dumps(payload, default=str, sort_keys=True)
    return hashlib.sha256(canonical.encode()).hexdigest()


class FlightRecorder:
    """Rolling last-K black-box dumps in one directory.

    Constructed programmatically (``install_flight_recorder(FlightRecorder
    (dir))``) or implicitly from ``METRICS_TPU_FLIGHTREC_DIR``. The
    directory is validated eagerly here (programmatic misconfiguration is
    code, not deployment config — it raises); the env path degrades with a
    warn-once instead (see :func:`active_flight_recorder`).
    """

    def __init__(
        self,
        directory: str,
        keep: Optional[int] = None,
        min_interval_s: float = _DEFAULT_MIN_INTERVAL_S,
    ) -> None:
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        probe = os.path.join(self.directory, f".flightrec_probe_{os.getpid()}")
        # writability probe, removed immediately: torn-write durability is
        # meaningless here — tearing IS an acceptable probe outcome
        with open(probe, "w") as f:  # graft-lint: disable=GL502
            f.write("probe")
        os.remove(probe)
        self._keep = keep
        self.min_interval_s = float(min_interval_s)
        self._lock = named_lock("flightrec.FlightRecorder._lock", threading.Lock(), hot=True)
        self._seq = 0
        self._last_dump_mono: Dict[str, float] = {}  # kind -> last dump time
        self._dumps = 0
        self._failed = 0
        # re-entrancy guard: a dump that itself records a degradation (or a
        # listener racing another) must not recurse into a second dump
        self._dumping = threading.local()
        # in-flight async dump threads (the health-listener path): joined
        # by flush() and the process-exit dump
        self._async_dumps: List[threading.Thread] = []

    @property
    def keep(self) -> int:
        return self._keep if self._keep is not None else _ENV_KEEP()

    # -- triggering ------------------------------------------------------

    def on_event(self, event: Dict[str, Any]) -> None:
        """The HealthRegistry listener body: dump on a degraded-edge
        transition — any non-informational kind, at most once per
        ``min_interval_s`` per kind (episode gate); informational
        milestones never trigger. The dump itself runs on a background
        thread: listeners run inline on the recording seam (an overloaded
        ``offer()`` recording ``overload_shed``), and a dump is a
        JSON-serialize + fsync — the seam must never pay that wall
        (:meth:`flush` is the join point). An event recorded MID-dump (a
        noisy source provider) is suppressed here — same-thread
        re-entrancy, the dump thread's own guard is set."""
        kind = event.get("kind", "<unknown>")
        if kind in INFORMATIONAL_EVENT_KINDS:
            return None
        if getattr(self._dumping, "active", False):
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_mono.get(kind)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last_dump_mono[kind] = now
        t = threading.Thread(
            target=self.dump,
            args=(kind, event.get("message", "")),
            kwargs={"reason": "degraded-edge"},
            daemon=True,
            name="metrics-tpu-flightrec-dump",
        )
        with self._lock:
            self._async_dumps = [x for x in self._async_dumps if x.is_alive()]
            self._async_dumps.append(t)
        t.start()
        return None

    def flush(self, timeout_s: float = 30.0) -> None:
        """Join in-flight async dumps (the degraded-edge path) — the
        deterministic point after which every triggered dump is on disk;
        tests and the process-exit hook call it before reading the
        directory."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            pending = list(self._async_dumps)
        for t in pending:
            t.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            self._async_dumps = [x for x in self._async_dumps if x.is_alive()]

    def dump(self, kind: str, message: str, reason: str = "manual") -> Optional[str]:
        """Write one black-box dump; returns its path, or None when the
        write failed (warn-once — the recorder must never take the
        triggering seam down with it) or a dump is already in flight on
        this thread (re-entrancy)."""
        if getattr(self._dumping, "active", False):
            return None
        self._dumping.active = True
        try:
            payload = self._build_payload(kind, message, reason)
            doc = {
                "magic": MAGIC,
                "schema_version": SCHEMA_VERSION,
                "sha256": _payload_digest(payload),
                "payload": payload,
            }
            with self._lock:
                self._seq += 1
                seq = self._seq
            safe_kind = re.sub(r"[^A-Za-z0-9_-]", "_", kind) or "event"
            path = os.path.join(
                self.directory,
                f"flightrec.{int(time.time() * 1000)}.{os.getpid()}.{seq}.{safe_kind}.json",
            )
            # serializing a whole black box is a blocking seam the witness
            # flags under any hot lock (the dump thread must hold none)
            note_blocking("json-serialize", path)
            atomic_write_bytes(path, json.dumps(doc, default=str).encode())
            with self._lock:
                self._dumps += 1
            self._prune()
            return path
        except Exception as err:  # noqa: BLE001 — the black box degrades, never the seam
            with self._lock:
                self._failed += 1
            _warn_once(
                ("dump", type(err).__name__),
                f"flight-recorder dump to {self.directory!r} failed "
                f"({type(err).__name__}: {err}); dumps are disabled-by-failure until "
                "the cause clears",
            )
            return None
        finally:
            self._dumping.active = False

    def _build_payload(self, kind: str, message: str, reason: str) -> Dict[str, Any]:
        from metrics_tpu_torch.obs import trace as _trace

        payload: Dict[str, Any] = {
            "created_unix": time.time(),
            "pid": os.getpid(),
            "trigger": {"kind": kind, "message": message, "reason": reason},
            "events": _health_registry.events(),
            "event_kinds": _health_registry.kinds(),
            "spans": [r._asdict() for r in _trace.trace_records()[-_SPANS_CAP:]],
            "sources": _snapshot_sources(),
        }
        try:
            # the last scrape a production scraper would have read — the
            # full exporter render (health + runtime quantiles). Host-side
            # numpy only; a failure degrades to the error string.
            from metrics_tpu_torch.obs.export import prometheus_text
            from metrics_tpu_torch.obs.runtime_metrics import host_only_reads
            from metrics_tpu_torch.resilience.health import health_report

            if reason in _EXIT_REASONS:
                # at exit or in the SIGTERM handler: no read of the card
                with host_only_reads():
                    payload["scrape"] = prometheus_text(health=health_report())
            else:
                payload["scrape"] = prometheus_text(health=health_report())
        except Exception as err:  # noqa: BLE001 — a wedged scrape is itself evidence
            payload["scrape_error"] = f"{type(err).__name__}: {err}"
        return payload

    def _prune(self) -> None:
        """Rolling retention is per PID: a surviving process pruning a
        shared directory must never eat a DEAD sibling's last dumps — the
        dead process's files are exactly the forensics the directory
        exists to keep (each process bounds its own window; a shared dir
        holds last-K per process)."""
        by_pid: Dict[int, List[Tuple[Tuple[int, int], str]]] = {}
        for name in os.listdir(self.directory):
            m = _FILE_RE.match(name)
            if m is not None:
                by_pid.setdefault(int(m.group("pid")), []).append(
                    ((int(m.group("ms")), int(m.group("seq"))), name)
                )
        for entries in by_pid.values():
            entries.sort()
            for _key, name in entries[: max(0, len(entries) - self.keep)]:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:  # pragma: no cover — racing prune from another process
                    pass

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"dumps": self._dumps, "failed": self._failed}


# --------------------------------------------------------------------------
# arming: programmatic > env; the health listener + process-exit hooks
# --------------------------------------------------------------------------

_state_lock = named_lock("flightrec._state_lock", threading.Lock(), hot=True)
_installed: Optional[FlightRecorder] = None
_env_recorder: Optional[Tuple[str, Optional[FlightRecorder]]] = None  # (raw dir, recorder)
_atexit_armed = False
_sigterm_armed = False
_prev_sigterm: Any = None


def install_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Programmatic arm (wins over the env var); ``None`` uninstalls."""
    global _installed
    with _state_lock:
        _installed = recorder
    if recorder is not None:
        _arm_process_hooks()


def active_flight_recorder() -> Optional[FlightRecorder]:
    """The recorder in effect: programmatic install > the env-named
    directory (memoized per raw value; an unusable path warns once and
    answers None — a bad env var degrades forensics, never serving)."""
    global _env_recorder
    with _state_lock:
        if _installed is not None:
            return _installed
    raw = _ENV_DIR()
    if not raw:
        return None
    with _state_lock:
        if _env_recorder is not None and _env_recorder[0] == raw:
            return _env_recorder[1]
    try:
        recorder: Optional[FlightRecorder] = FlightRecorder(raw)
    except OSError as err:
        _warn_once(
            ("flightrec-dir", raw),
            f"{_DIR_ENV}={raw!r} is not a usable directory ({type(err).__name__}: "
            f"{err}); the flight recorder stays disabled — degradations are not "
            "black-boxed (serving unaffected)",
        )
        recorder = None
    with _state_lock:
        _env_recorder = (raw, recorder)
    if recorder is not None:
        _arm_process_hooks()
    return recorder


def _health_listener(event: Dict[str, Any]) -> None:
    recorder = active_flight_recorder()
    if recorder is not None:
        recorder.on_event(event)


def _exit_dump(reason: str = "atexit") -> Optional[str]:
    """The process-exit dump (atexit + SIGTERM): unconditional — the gate
    exists to bound per-kind flood, and there is exactly one exit."""
    recorder = active_flight_recorder()
    if recorder is None:
        return None
    # settle in-flight degraded-edge dumps first: a daemon dump thread torn
    # by interpreter teardown would leave at worst a stale tmp, but joining
    # here makes the final directory state complete
    recorder.flush(timeout_s=5.0)
    return recorder.dump("shutdown", f"process exiting ({reason})", reason=reason)


def _on_sigterm(signum: int, frame: Any) -> None:
    _exit_dump(reason="sigterm")
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    elif prev != signal.SIG_IGN:
        # restore + re-raise so the process still dies with the default
        # disposition (a flight recorder must record the crash, not eat it)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _arm_process_hooks() -> None:
    """Idempotently register the atexit dump and chain the SIGTERM handler.

    The two halves arm independently: ``signal.signal`` raises off the
    main thread (and the FIRST arm often happens there — the env recorder
    resolves lazily from a health event on a serve-worker thread), so the
    SIGTERM half stays un-armed and RETRIES on every later arm call until
    one runs on the main thread. Marking everything armed on the first
    (worker-thread) call would silently lose the SIGTERM dump for the
    life of the process."""
    global _atexit_armed, _sigterm_armed, _prev_sigterm
    with _state_lock:
        arm_atexit = not _atexit_armed
        _atexit_armed = True
        sigterm_done = _sigterm_armed
    if arm_atexit:
        atexit.register(_exit_dump)
    if sigterm_done:
        return
    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # off the main thread — retried on the next arm
        return
    with _state_lock:
        _sigterm_armed = True
        _prev_sigterm = prev


# registered at import (obs/__init__ imports this module): zero cost while
# unarmed — one memoized env read per non-informational health event
_health_registry.add_listener(_health_listener)


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------


def load_flight_record(path: str) -> Dict[str, Any]:
    """Read + verify one dump → its payload dict. Raises
    :class:`FlightRecordError` naming the file on a torn write, checksum
    mismatch, or newer schema."""
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read())
    except FileNotFoundError:
        raise FlightRecordError(f"flight record {path} does not exist")
    except Exception as err:  # noqa: BLE001 — torn JSON must refuse typed
        raise FlightRecordError(
            f"flight record {path} is unreadable ({type(err).__name__}: {err}) — "
            "torn write or corruption"
        )
    if not isinstance(doc, dict) or doc.get("magic") != MAGIC:
        raise FlightRecordError(f"flight record {path} has no {MAGIC!r} magic header")
    version = doc.get("schema_version")
    if not isinstance(version, int) or version > SCHEMA_VERSION:
        raise FlightRecordError(
            f"flight record {path} has schema version {version!r}; this build "
            f"understands <= {SCHEMA_VERSION}"
        )
    payload = doc.get("payload")
    if not isinstance(payload, dict) or doc.get("sha256") != _payload_digest(payload):
        raise FlightRecordError(
            f"flight record {path} failed checksum verification — bit flip or "
            "partial write refused"
        )
    return payload


def load_flight_records(directory: str) -> List[Dict[str, Any]]:
    """Every verifiable dump in ``directory``, newest first; corrupt files
    are skipped with a warning naming them (the torn-write survivor
    contract: one bad file never hides the intact history)."""
    entries: List[Tuple[Tuple[int, int, int], str]] = []
    for name in os.listdir(directory):
        m = _FILE_RE.match(name)
        if m is not None:
            entries.append(
                ((int(m.group("ms")), int(m.group("pid")), int(m.group("seq"))), name)
            )
    out: List[Dict[str, Any]] = []
    for _key, name in sorted(entries, reverse=True):
        path = os.path.join(directory, name)
        try:
            out.append(load_flight_record(path))
        except FlightRecordError as err:
            _warn_once(("load", name), f"skipping corrupt flight record: {err}")
    return out


def reset_flightrec_state() -> None:
    """Test hook (the shared ``reset_*_state`` contract): drop the
    installed/env recorders, attached sources, warn-once memory, and the
    memoized env parses. Process-exit hooks stay armed (they re-resolve
    the active recorder at fire time, so disarming state suffices)."""
    global _installed, _env_recorder
    with _state_lock:
        _installed = None
        _env_recorder = None
    with _sources_lock:
        _SOURCES.clear()
    _warn_once.reset()
    _ENV_DIR.reset()
    _ENV_KEEP.reset()
