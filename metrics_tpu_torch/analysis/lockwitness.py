"""Runtime lock witness (counterpart of ``metrics_tpu/analysis/lockwitness.py``):
an opt-in, order-recording proxy around the port's named locks
(``METRICS_TPU_LOCKCHECK``).

It checks at run time the lock hierarchy of the JAX package's
``metrics_tpu/analysis/LOCK_ORDER.md`` (and the port's own locks, ROADMAP
D64), ThreadSanitizer-style at the lock granularity:

- every armed acquisition records the edge *held -> acquired* into one
  process-global order graph; an acquisition that would close a cycle in
  that graph is an **inversion** (two threads CAN deadlock on these locks,
  even if this run did not), reported with the sites of both orders;
- :func:`note_blocking` marks known blocking seams (fsync, JSON
  serialization, HTTP sends, collectives); reaching one while any **hot**
  lock is held is a finding;
- findings dump through the torn-write-proof writer
  (``resilience/snapshot.py::atomic_write_bytes``).

============================  =============================================
``METRICS_TPU_LOCKCHECK``     behavior
============================  =============================================
unset / empty                 disabled: :func:`named_lock` returns its
                              input lock **unchanged** (the identity)
``1/true/on/yes``             armed: named locks wrap in the witness proxy
``0/false/off/no``            disabled explicitly
malformed token               warns once (``ops/_envtools`` contract), stays
                              disabled
============================  =============================================

Arming is resolved when a lock is *created* (module import, object
construction), not per acquisition: a module-level lock is armed only when
the variable is set before the module is imported. Tests arm
programmatically with :func:`force_lockcheck`.

The standard library only at import; the variable is read through the
port's ``ops/_envtools`` at the first ``named_lock`` call.
"""
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "named_lock",
    "note_blocking",
    "lockcheck_enabled",
    "force_lockcheck",
    "findings",
    "clear_findings",
    "dump_findings",
    "reset_lockwitness_state",
]

# guards the witness's own tables; deliberately a bare threading.Lock —
# the witness must never witness itself
_meta_lock = threading.Lock()

_forced: Optional[bool] = None  # force_lockcheck() override (tests/soak)
_active = False  # fast gate for note_blocking: True once any witness exists

_tls = threading.local()  # .stack: List[_Held] per thread

# observed acquisition-order graph: name -> {successor -> first-seen site}
_order: Dict[str, Dict[str, str]] = {}
_findings: List[Dict[str, Any]] = []

_env: Any = None  # lazily built EnvParse (keeps analysis/ import-light)
_warn_once: Any = None


def _lockcheck_env() -> bool:
    global _env, _warn_once
    if _env is None:
        from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce, bool_token

        warn = WarnOnce()

        def parse(raw: str) -> bool:
            val = bool_token(raw)
            if val is None:
                warn(
                    ("METRICS_TPU_LOCKCHECK", raw),
                    f"METRICS_TPU_LOCKCHECK={raw!r} is not a boolean token "
                    "(1/0/true/false/on/off/yes/no) — lock witness stays "
                    "DISABLED",
                )
                return False
            return val

        _warn_once = warn
        _env = EnvParse("METRICS_TPU_LOCKCHECK", parse, False)
    return bool(_env())


def lockcheck_enabled() -> bool:
    """Is the witness armed right now (``force_lockcheck`` override first,
    else the env knob)? Locks created while this is False are NOT wrapped —
    arming mid-process only affects locks created afterwards."""
    if _forced is not None:
        return _forced
    return _lockcheck_env()


def force_lockcheck(on: Optional[bool] = True) -> None:
    """Programmatic override (tests / the soak harness): ``True``/``False``
    pin the state; ``None`` returns control to the env knob."""
    global _forced
    _forced = on


class _Held:
    __slots__ = ("name", "hot", "count")

    def __init__(self, name: str, hot: bool) -> None:
        self.name = name
        self.hot = hot
        self.count = 1


def _stack() -> List[_Held]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _thread_site() -> str:
    t = threading.current_thread()
    held = "+".join(e.name for e in _stack())
    return f"thread={t.name} held=[{held}]"


def _path_exists(src: str, dst: str) -> bool:
    """Is ``dst`` reachable from ``src`` in the observed order graph?
    Caller holds ``_meta_lock``."""
    seen = {src}
    frontier = [src]
    while frontier:
        node = frontier.pop()
        for nxt in _order.get(node, ()):
            if nxt == dst:
                return True
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return False


def _record_edges(name: str) -> None:
    """Record held → ``name`` edges; an edge whose reverse path already
    exists is an inversion (the global observed order has a cycle)."""
    held = [e.name for e in _stack()]
    if not held:
        return
    site = _thread_site()
    with _meta_lock:
        for h in held:
            succ = _order.setdefault(h, {})
            if name in succ:
                continue
            if _path_exists(name, h):
                _findings.append(
                    {
                        "kind": "inversion",
                        "edge": f"{h} -> {name}",
                        "site": site,
                        "conflicts_with": _order.get(name, {}).get(h)
                        or "earlier-observed reverse ordering",
                    }
                )
            succ[name] = site


class _WitnessLock:
    """Order-recording proxy over one named lock. Wraps Lock/RLock (and
    Condition: ``wait`` transparently un-holds for the duration, matching
    the real release-and-reacquire semantics)."""

    def __init__(self, name: str, base: Any, hot: bool) -> None:
        self._name = name
        self._base = base
        self._hot = hot

    # -- lock protocol ------------------------------------------------------

    def acquire(self, *args: Any, **kwargs: Any) -> Any:
        got = self._base.acquire(*args, **kwargs)
        if got:
            self._on_acquired()
        return got

    def release(self) -> None:
        self._on_released()
        self._base.release()

    def __enter__(self) -> Any:
        got = self._base.__enter__()
        self._on_acquired()
        return got

    def __exit__(self, *exc: Any) -> Any:
        self._on_released()
        return self._base.__exit__(*exc)

    def locked(self) -> bool:
        return self._base.locked()

    # -- Condition pass-throughs -------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        entry = self._pop_entry()
        try:
            return self._base.wait(timeout)
        finally:
            if entry is not None:
                _stack().append(entry)

    def wait_for(self, predicate: Any, timeout: Optional[float] = None) -> Any:
        entry = self._pop_entry()
        try:
            return self._base.wait_for(predicate, timeout)
        finally:
            if entry is not None:
                _stack().append(entry)

    def notify(self, n: int = 1) -> None:
        self._base.notify(n)

    def notify_all(self) -> None:
        self._base.notify_all()

    # -- bookkeeping --------------------------------------------------------

    def _on_acquired(self) -> None:
        st = _stack()
        for e in st:
            if e.name == self._name:  # re-entrant (RLock/Condition): no edge
                e.count += 1
                return
        _record_edges(self._name)
        st.append(_Held(self._name, self._hot))

    def _on_released(self) -> None:
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i].name == self._name:
                st[i].count -= 1
                if st[i].count == 0:
                    del st[i]
                return

    def _pop_entry(self) -> Optional[_Held]:
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i].name == self._name:
                entry = st[i]
                del st[i]
                return entry
        return None


def named_lock(name: str, lock: Optional[Any] = None, hot: bool = False) -> Any:
    """Register a named lock with the witness.

    Disabled (the default): returns ``lock`` (or a fresh ``Lock``)
    **unchanged** — the shim is the identity, zero overhead on every
    subsequent acquire. Armed: returns the witness proxy. ``hot`` marks
    locks whose critical sections must never reach a blocking seam
    (:func:`note_blocking`); the collective serializer is deliberately NOT
    hot — blocking under it is its job (``LOCK_ORDER.md``)."""
    global _active
    base = lock if lock is not None else threading.Lock()
    if not lockcheck_enabled():
        return base
    _active = True
    return _WitnessLock(name, base, hot)


def note_blocking(kind: str, detail: str = "") -> None:
    """Mark a blocking seam (fsync / json-serialize / http / collective).
    A no-op unless the witness is armed AND the calling thread holds a hot
    lock — the disabled path is one module-global bool check."""
    if not _active:
        return
    hot = [e.name for e in _stack() if e.hot]
    if not hot:
        return
    with _meta_lock:
        _findings.append(
            {
                "kind": "blocking-under-hot-lock",
                "blocking": kind,
                "detail": detail,
                "held": hot,
                "site": _thread_site(),
            }
        )


def findings() -> List[Dict[str, Any]]:
    with _meta_lock:
        return list(_findings)


def clear_findings() -> None:
    with _meta_lock:
        _findings.clear()


def dump_findings(path: str) -> str:
    """Write current findings as JSON through the flight recorder's
    torn-write-proof path. Returns ``path``."""
    import json

    from metrics_tpu_torch.resilience.snapshot import atomic_write_bytes

    blob = json.dumps({"findings": findings()}, indent=2, sort_keys=True).encode("utf-8")
    atomic_write_bytes(path, blob)
    return path


def reset_lockwitness_state() -> None:
    """Test isolation: forget the observed order graph, findings, the
    forced override, and the memoized env parse (same hook shape as
    ``reset_flightrec_state``)."""
    global _forced, _active
    with _meta_lock:
        _order.clear()
        _findings.clear()
    _forced = None
    _active = False
    if _env is not None:
        _env.reset()
    if _warn_once is not None:
        _warn_once.reset()
