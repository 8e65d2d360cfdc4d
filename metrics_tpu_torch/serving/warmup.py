"""Serving warmup (counterpart of ``metrics_tpu/serving/warmup.py``).

It captures the serving graphs before the first request.

The padding ladder (``ops/padding.py``) bounds how many update graphs
ragged traffic needs; without a warmup each replica still runs the first
request at a tier eagerly and captures at the second. :class:`WarmupEngine`
moves that off the request path: from one example request
(:class:`Warmup`) it enumerates the ladder's tiers and, on a background
thread, largest tier first (the costliest miss first), captures every
replica's update graph for each member and tier.

- **The eager pre-pass runs on an isolated clone**, never on a live
  replica: one update per member and tier on the example's rows resolves
  the data-inferred attributes (``_snapshot_attrs``), loads the kernel
  libraries and warms the allocator, as the JAX package traces on a clone.
- **The capture runs against each replica's states** (a CUDA graph replays
  fixed pointers), under the replica's lock, so its worker cannot update
  meanwhile; the clone's attributes are set on the replica where still
  unset, as a warmed hit applies them in the JAX package. A capture runs
  nothing on the card and leaves the states as they were.
- **Not shared across replicas.** The JAX package shares one executable
  among every replica and reporter clone; a CUDA graph is bound to its
  replica's state tensors, so the port captures once per replica, member
  and tier. The per-replica table of graphs,
  :class:`~metrics_tpu_torch._capture.UpdateGraphs`, is the counterpart of
  ``AOTDispatcher`` and is exported under that name.
- **``compute`` is not captured** (stated difference): every reduce builds
  a new reporter clone, whose graph would never replay. A member's compute
  entry counts as skipped, as do the members whose update is not captured
  (the CPU, ``jittable_update`` False, ``compute_on_cpu``,
  ``debug_checks``), as the JAX package counts its eager-only members.
- **No persistent cache** (stated difference): a CUDA graph cannot outlive
  its process, so ``METRICS_TPU_COMPILE_CACHE_DIR`` has no counterpart and
  :func:`configure_compile_cache` returns None. The kernel libraries
  already persist under ``metrics_tpu_torch/_build/``.

A capture runs in ``thread_local`` mode on a side stream of the warmup
thread, so the workers' allocations and synchronizations meanwhile do not
invalidate it. Status walks ``pending -> running -> done | failed |
stopped``; a failure records ``serve_warmup_error`` and serving goes on
with eager first updates. ``METRICS_TPU_WARMUP=0`` skips the engine.

Telemetry, as in the JAX package: a ``serve.warmup`` span, the
``serve_warmup_seconds`` and ``serve_warmup_graphs`` gauges, and, while
tracing is on, each capture's wall time per tier in the
``serve_warmup_capture_ms`` histograms (``observe_jit_wall``). Each capture
also counts in ``metric_jit_retrace_total`` (``_capture.py``).
"""
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from metrics_tpu_torch._capture import UpdateGraphs, eager_updates
from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce, bool_token

__all__ = [
    "Warmup",
    "WarmupEngine",
    "AOTDispatcher",
    "configure_compile_cache",
    "warmup_enabled",
    "reset_warmup_state",
]

_CACHE_ENV = "METRICS_TPU_COMPILE_CACHE_DIR"
_WARMUP_ENV = "METRICS_TPU_WARMUP"

_warn_once = WarnOnce()

# the per-replica table of captured update graphs
AOTDispatcher = UpdateGraphs


def _parse_warmup(raw: str) -> bool:
    value = bool_token(raw)
    if value is None:
        _warn_once(
            ("warmup", raw),
            f"{_WARMUP_ENV}={raw!r} is not a boolean token (1/0/true/false/on/off/yes/no); warmup stays enabled.",
        )
        return True
    return value


_ENV_WARMUP: "EnvParse[bool]" = EnvParse(_WARMUP_ENV, _parse_warmup, True)
_ENV_CACHE_DIR: "EnvParse[str]" = EnvParse(_CACHE_ENV, lambda raw: raw, "")


def warmup_enabled() -> bool:
    """Whether a warmup may run: ``METRICS_TPU_WARMUP=0`` turns it off
    (default on)."""
    return _ENV_WARMUP()


def configure_compile_cache() -> Optional[str]:
    """None: a CUDA graph cannot outlive its process, so there is no
    persistent cache to point at ``METRICS_TPU_COMPILE_CACHE_DIR`` (set, it
    warns once)."""
    raw = _ENV_CACHE_DIR()
    if raw:
        _warn_once(
            ("cache-dir", raw),
            f"{_CACHE_ENV}={raw!r} has no effect here: captured CUDA graphs live in their process "
            "(the kernel libraries persist under metrics_tpu_torch/_build/)",
        )
    return None


def reset_warmup_state() -> None:
    """Forget the warnings given and the memoized parses (for tests)."""
    _warn_once.reset()
    _ENV_WARMUP.reset()
    _ENV_CACHE_DIR.reset()


def _rows(value: Any) -> Optional[int]:
    shape = getattr(value, "shape", None)
    if shape is None:
        shape = np.asarray(value).shape
    return int(shape[0]) if len(shape) >= 1 else None


class Warmup:
    """The warmup of one served metric tree, from one representative
    request.

    ``example_args``/``example_kwargs`` are one request as it arrives
    (numpy arrays or tensors); its rows should look like real traffic, since
    the pre-pass infers the data-inferred attributes from them. Each
    row-aligned argument is resized to every tier (its rows repeated). The
    tiers come from ``ladder``, else ``METRICS_TPU_PAD_LADDER`` through
    :func:`~metrics_tpu_torch.ops.padding.ladder_tiers`, up to ``max_rows``
    (default: the example's rows). ``compute`` is kept for the JAX
    package's signature: compute graphs are never captured.
    """

    def __init__(
        self,
        example_args: Sequence[Any],
        example_kwargs: Optional[Dict[str, Any]] = None,
        ladder: Optional[Sequence[int]] = None,
        max_rows: Optional[int] = None,
        compute: bool = True,
    ) -> None:
        if not example_args:
            raise ValueError("Warmup needs at least one example update argument")
        self.example_args = tuple(example_args)
        self.example_kwargs = dict(example_kwargs or {})
        self.ladder = tuple(ladder) if ladder is not None else None
        self.max_rows = max_rows
        self.compute = bool(compute)

    def _example_rows(self) -> int:
        for v in list(self.example_args) + list(self.example_kwargs.values()):
            n = _rows(v)
            if n is not None:
                return n
        raise ValueError("Warmup example has no row-aligned (>=1-dim) argument to enumerate padding tiers from")

    def tiers(self) -> Tuple[int, ...]:
        """The padding tiers this warmup covers, ascending."""
        from metrics_tpu_torch.ops.padding import ladder_tiers

        max_rows = self.max_rows if self.max_rows is not None else self._example_rows()
        return ladder_tiers(max_rows, ladder=self.ladder)

    def tier_args(self, tier: Optional[int]) -> Tuple[tuple, dict]:
        """The example as a request of ``tier`` rows (None: as given): each
        row-aligned argument's rows repeated to ``tier``. The padding adds
        the ``valid`` mask, as on a live request."""
        rows = self._example_rows()

        def leaf(v: Any) -> Any:
            if tier is None or _rows(v) != rows:
                return v
            if hasattr(v, "detach"):
                v = v.detach().cpu().numpy()
            arr = np.asarray(v)
            return np.resize(arr, (tier,) + arr.shape[1:])

        return tuple(leaf(v) for v in self.example_args), {k: leaf(v) for k, v in self.example_kwargs.items()}


def _captures(m: Any) -> bool:
    """Whether ``m``'s update is captured on its device."""
    return m.device.type == "cuda" and m._can_jit_update() and not m.compute_on_cpu and not m.debug_checks


class WarmupEngine:
    """Capture a served prototype's update graphs on every replica, on a
    background thread. ``start(replicas, locks)`` runs it; :meth:`state`
    reports ``status``, ``graphs_captured``, ``graphs_skipped`` (the
    entries that have no graph: compute, eager members, refused captures)
    and ``wall_s``."""

    def __init__(self, prototype: Any, spec: Warmup, name: Optional[str] = None) -> None:
        if not isinstance(spec, Warmup):
            raise TypeError(f"warmup= expects a metrics_tpu_torch.serving.Warmup spec, got {type(spec).__name__}")
        self._proto = prototype
        self.spec = spec
        self.name = name or type(prototype).__name__
        self.status = "pending"
        self.error: Optional[str] = None
        self.graphs_captured = 0
        self.graphs_skipped = 0
        self.wall_s: Optional[float] = None
        self.started_unix: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, replicas: Sequence[Any], locks: Sequence[Any]) -> "WarmupEngine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, args=(list(replicas), list(locks)), daemon=True, name=f"serve-warmup-{self.name}"
            )
            self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop between captures (the graphs captured so far stay)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the warmup thread ends; True when it did."""
        if self._thread is None:
            return False
        self._thread.join(timeout=timeout_s)
        return not self._thread.is_alive()

    def state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "status": self.status,
            "graphs_captured": self.graphs_captured,
            "graphs_skipped": self.graphs_skipped,
            "wall_s": self.wall_s,
        }
        if self.error is not None:
            out["error"] = self.error
        return out

    def _run(self, replicas: List[Any], locks: List[Any]) -> None:
        from metrics_tpu_torch.obs import trace as _obs_trace
        from metrics_tpu_torch.obs.runtime_metrics import registry as _runtime
        from metrics_tpu_torch.resilience.health import record_degradation

        self.status = "running"
        self.started_unix = time.time()
        t0 = time.monotonic()
        try:
            with _obs_trace.span("serve.warmup", metric=self.name):
                self._capture_all(replicas, locks)
            self.wall_s = time.monotonic() - t0
            _runtime.gauge("serve_warmup_seconds").set(self.wall_s)
            _runtime.gauge("serve_warmup_graphs").set(self.graphs_captured)
            if self._stop.is_set():
                self.status = "stopped"
                return
            self.status = "done"
            record_degradation(
                "serve_warmup_done",
                f"warmup for {self.name} captured {self.graphs_captured} graphs "
                f"({self.graphs_skipped} skipped) in {self.wall_s:.2f}s",
                metric=self.name,
                graphs=self.graphs_captured,
                wall_s=round(self.wall_s, 3),
            )
        except Exception as err:  # noqa: BLE001 - a warmup failure must never stop serving
            self.wall_s = time.monotonic() - t0
            self.status = "failed"
            self.error = f"{type(err).__name__}: {err}"
            _runtime.gauge("serve_warmup_seconds").set(self.wall_s)
            _runtime.gauge("serve_warmup_graphs").set(self.graphs_captured)
            record_degradation(
                "serve_warmup_error",
                f"warmup for {self.name} failed after {self.graphs_captured} graphs: {self.error}; "
                "serving goes on with eager first updates",
                metric=self.name,
            )

    def _member_tiers(self, m: Any) -> List[Optional[int]]:
        """Largest tier first; an unpadded member's live calls carry the
        caller's shapes, so it warms the example's shape only (None)."""
        return sorted(self.spec.tiers(), reverse=True) if m.pad_batches else [None]

    def _capture_all(self, replicas: List[Any], locks: List[Any]) -> None:
        from metrics_tpu_torch.obs.runtime_metrics import observe_jit_wall
        from metrics_tpu_torch.obs.trace import tracing_enabled
        from metrics_tpu_torch.ops.padding import pad_update_args
        from metrics_tpu_torch.serving.loop import _apply_inferred_attrs, _clone, _inferred_attrs, _members

        compute_entries = 1 if self.spec.compute else 0
        template = _clone(self._proto)
        members = _members(template)
        # the eager pre-pass, on the isolated clone
        attrs: Dict[str, Dict[str, Dict[str, Any]]] = {}
        with eager_updates():
            for name, m in members:
                if not _captures(m):
                    continue
                for tier in self._member_tiers(m):
                    args, kwargs = self.spec.tier_args(tier)
                    m.update(*args, **m._filter_kwargs(**kwargs))
                attrs[name] = _inferred_attrs(m)
        for replica, lock in zip(replicas, locks):
            for name, m in _members(replica):
                tiers = self._member_tiers(m)
                self.graphs_skipped += compute_entries
                if name not in attrs:
                    self.graphs_skipped += len(tiers)
                    continue
                for tier in tiers:
                    if self._stop.is_set():
                        return
                    args, kwargs = self.spec.tier_args(tier)
                    kwargs = m._filter_kwargs(**kwargs)
                    with lock:
                        if not m._can_jit_update():
                            self.graphs_skipped += 1
                            continue
                        _apply_inferred_attrs(m, attrs[name])
                        args = tuple(m._to_device(a) for a in args)
                        kwargs = {k: m._to_device(v) for k, v in kwargs.items()}
                        if m.pad_batches:
                            args, kwargs, _ = pad_update_args(m, args, kwargs)
                        table = m._update_graph_table()
                        t0 = time.perf_counter() if tracing_enabled() else None
                        if table is not None and table.prepare(m, m._original_update, args, kwargs):
                            self.graphs_captured += 1
                            if t0 is not None:
                                # the capture's wall time per ladder tier
                                observe_jit_wall("serve_warmup_capture", tier, (time.perf_counter() - t0) * 1e3)
                        else:
                            self.graphs_skipped += 1
