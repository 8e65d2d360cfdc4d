"""Process-wide self-telemetry (counterpart of
``metrics_tpu/obs/runtime_metrics.py``): counters, gauges and latency
histograms backed by the port's own quantile sketch.

The tracer's sink feeds it: every completed span lands in its
``<seam>_total`` counter, and the spans of the :data:`HISTOGRAM_SEAMS`
table also observe their duration into the matching ``*_ms`` histogram.
An observation appends to a bounded host buffer; the buffer folds into a
:class:`~metrics_tpu_torch.streaming.sketches.QuantileSketchState` when it
holds 8192 samples or a merge needs it. That fold is kernel K3
(``csrc/compactor_fold.cu``) on the card.

The fold's device is explicit: :attr:`RuntimeMetrics.fold_device`, read at
a histogram's first fold and never at import. ``None`` means CUDA, as for a
metric, and raises without a card; a test on the CPU sets it to ``"cpu"``.
The read path (:meth:`LatencyHistogram.quantiles`) reads the sketch's
levels back once per scrape, never on the write path, and the light
snapshot (counts and sums, what ``health_report()`` embeds) reads nothing
from the device. Inside :func:`host_only_reads` (the flight recorder's exit
dump) a histogram folded on the card reports no quantiles rather than read
the device.

JAX counts a jit (re)trace of a metric's update in
``metric_jit_retrace_total``; the port counts a CUDA-graph capture there
(``_capture.py``), the step that makes a new compiled update, so that one
dashboard reads both packages.

Its locks are the JAX package's named locks (``analysis/lockwitness.py``).
"""
import contextlib
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from metrics_tpu_torch.analysis.lockwitness import named_lock
from metrics_tpu_torch.ops._envtools import WarnOnce

_warn_once = WarnOnce()

__all__ = [
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "RuntimeMetrics",
    "registry",
    "merged",
    "note_jit_retrace",
    "observe_jit_wall",
    "host_only_reads",
    "HISTOGRAM_SEAMS",
    "DEFAULT_QUANTILES",
]

DEFAULT_QUANTILES: Tuple[float, ...] = (0.5, 0.99, 0.999)

# histogram geometry: eps is the KLL rank-error fraction reported alongside
# every quantile; 1<<20 observed rows before the top level can saturate
_HIST_EPS = 0.01
_HIST_MAX_ITEMS = 1 << 20

# pending-buffer bound: the observe path folds into the sketch once per
# this many samples
_PENDING_CAP = 8192

# span name -> histogram name: the instrumented seams whose latency
# distributions are pre-registered (every span has an occurrence counter;
# only these carry a histogram)
HISTOGRAM_SEAMS: Dict[str, str] = {
    "metric.update": "metric_update_ms",
    "metric.sync_dist": "metric_sync_ms",
    "metric.compute": "metric_compute_ms",
    "async_sync.cycle": "async_cycle_ms",
    "async_sync.snapshot": "async_snapshot_ms",
    "async_sync.reduce": "async_reduce_ms",
    "serve.offer": "serve_offer_ms",
    "serve.update": "serve_update_ms",
    "serve.reduce": "serve_reduce_ms",
    "serve.forced_reduce": "serve_forced_reduce_ms",
    "snapshot.save": "snapshot_save_ms",
    "snapshot.restore": "snapshot_restore_ms",
}

# set while the flight recorder's exit dump renders: reads of a sketch on
# the card are skipped, so a process exit never touches the device
_host_only = threading.local()


@contextlib.contextmanager
def host_only_reads() -> Iterator[None]:
    """Within this block (on this thread), a histogram whose sketch lies on
    the card answers no quantiles instead of reading it back."""
    prev = getattr(_host_only, "on", False)
    _host_only.on = True
    try:
        yield
    finally:
        _host_only.on = prev


class Counter:
    """Monotonic named counter (thread-safe; int, never wraps)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = named_lock("runtime_metrics.Counter._lock", threading.Lock(), hot=True)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins named value (thread-safe): point-in-time facts a
    scraper reads as they are. ``None`` until first set (exporters skip
    unset gauges)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = named_lock("runtime_metrics.Gauge._lock", threading.Lock(), hot=True)
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


def _np_weighted_quantiles(values: Any, weights: Any, qs: Sequence[float]) -> List[float]:
    """Host inverse-CDF quantiles over ``(value, weight)`` rows, as the JAX
    package computes them on its scrape path."""
    import numpy as np

    v = np.asarray(values, np.float64).reshape(-1)
    w = np.asarray(weights, np.float64).reshape(-1)
    keep = w > 0
    v, w = v[keep], w[keep]
    if v.size == 0:
        return [float("nan")] * len(qs)
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cum = np.cumsum(w)
    total = cum[-1]
    out = []
    for q in qs:
        idx = int(np.searchsorted(cum, q * total, side="left"))
        out.append(float(v[min(idx, v.size - 1)]))
    return out


class LatencyHistogram:
    """One latency distribution (milliseconds) at fixed state size.

    :meth:`observe` appends to a bounded host buffer, which folds into a
    quantile sketch when full (K3 on the card). Quantiles carry the
    sketch's rank-error contract: off by at most ``eps * n`` ranks; pending
    (not yet folded) samples are exact. ``device`` is where the sketch
    lives; ``None`` follows the owning registry's ``fold_device`` (CUDA
    when that is ``None`` too), resolved at the first fold.
    """

    def __init__(
        self,
        name: str,
        eps: float = _HIST_EPS,
        max_items: int = _HIST_MAX_ITEMS,
        device: Any = None,
        owner: Optional["RuntimeMetrics"] = None,
    ) -> None:
        self.name = name
        self.eps = float(eps)
        self.max_items = int(max_items)
        self.device = device
        self._owner = owner
        self._lock = named_lock("runtime_metrics.LatencyHistogram._lock", threading.RLock(), hot=True)
        self._pending: List[float] = []
        self._sketch: Any = None  # QuantileSketchState, built at the first fold
        self._count = 0
        self._sum = 0.0
        self.folds = 0  # sketch inserts so far (one K3 launch each on the card)

    # -- write path ----------------------------------------------------

    def observe(self, value_ms: float) -> None:
        with self._lock:
            self._pending.append(float(value_ms))
            self._count += 1
            self._sum += float(value_ms)
            if len(self._pending) >= _PENDING_CAP:
                self._fold_locked()

    def observe_ns(self, dur_ns: int) -> None:
        self.observe(dur_ns / 1e6)

    def fold_device(self) -> Any:
        """The device the sketch is (or will be) built on."""
        if self._sketch is not None:
            return self._sketch.items.device
        if self.device is not None:
            return self.device
        return self._owner.fold_device if self._owner is not None else None

    def _fold_locked(self) -> None:
        if not self._pending:
            return
        import torch

        from metrics_tpu_torch.streaming.sketches import QuantileSketchState

        if self._sketch is None:
            self._sketch = QuantileSketchState.create(eps=self.eps, max_items=self.max_items, device=self.fold_device())
        values = torch.tensor(self._pending, dtype=torch.float32).to(self._sketch.items.device)
        self._sketch = self._sketch.insert(values)
        self._pending = []
        self.folds += 1

    # -- read path: the levels come back once per scrape -----------------

    def _levels(self) -> Optional[Tuple[List[float], List[float]]]:
        """(values, weights) rows of the folded sketch plus the exact
        pending tail (weight 1 each); None inside :func:`host_only_reads`
        when the sketch lies on the card."""
        values: List[float] = []
        weights: List[float] = []
        if self._sketch is not None:
            if getattr(_host_only, "on", False) and self._sketch.items.device.type != "cpu":
                return None
            items = self._sketch.items.cpu().numpy()
            counts = self._sketch.counts.cpu().numpy()
            for lvl in range(items.shape[0]):
                c = int(counts[lvl])
                if c > 0:
                    values.extend(items[lvl, :c].tolist())
                    weights.extend([float(1 << lvl)] * c)
        values.extend(self._pending)
        weights.extend([1.0] * len(self._pending))
        return values, weights

    def quantiles(self, qs: Sequence[float] = DEFAULT_QUANTILES) -> Optional[Dict[float, float]]:
        with self._lock:
            levels = self._levels()
        if levels is None:
            return None
        return dict(zip(qs, _np_weighted_quantiles(levels[0], levels[1], qs)))

    # count/sum read WITHOUT the lock: python int/float loads are atomic
    # under the GIL, and the lock may be held across a fold — the light
    # snapshot (what health_report embeds) must answer meanwhile
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum_ms(self) -> float:
        return self._sum

    # -- merge (the cross-worker path) ------------------------------------

    def merged(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """A new histogram covering both streams: counts and sums add, the
        sketches union through ``sketch_merge`` (K3 on the card)."""
        if self.eps != other.eps or self.max_items != other.max_items:
            raise ValueError(
                f"cannot merge histogram {self.name!r} (eps={self.eps}, "
                f"max_items={self.max_items}) with {other.name!r} "
                f"(eps={other.eps}, max_items={other.max_items})"
            )
        out = LatencyHistogram(self.name, eps=self.eps, max_items=self.max_items, device=self.fold_device())
        # canonical lock order (by id): two threads merging the same pair in
        # opposite directions must not deadlock
        first, second = (self, other) if id(self) <= id(other) else (other, self)
        with first._lock:
            with second._lock:
                self._fold_locked()
                other._fold_locked()
                sk_a, count_a, sum_a = self._sketch, self._count, self._sum
                sk_b, count_b, sum_b = other._sketch, other._count, other._sum
        if sk_a is not None and sk_b is not None:
            if sk_b.items.device != sk_a.items.device:
                sk_b = type(sk_b)(*(t.to(sk_a.items.device) for t in sk_b))
            out._sketch = sk_a.sketch_merge(sk_b)
        else:
            out._sketch = sk_a if sk_a is not None else sk_b
        out._count = count_a + count_b
        out._sum = sum_a + sum_b
        return out

    def snapshot(self, qs: Sequence[float] = DEFAULT_QUANTILES) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": self.count, "sum_ms": self.sum_ms, "eps": self.eps}
        quantiles = self.quantiles(qs)
        if quantiles is not None:
            out["quantiles_ms"] = {f"{q:g}": quantiles[q] for q in qs}
        return out


class RuntimeMetrics:
    """One registry of named counters, gauges and histograms (get or
    create). ``fold_device`` is where its histograms' sketches are built
    (``None``: CUDA)."""

    def __init__(self, fold_device: Any = None) -> None:
        self.fold_device = fold_device
        self._lock = named_lock("runtime_metrics.RuntimeMetrics._lock", threading.Lock(), hot=True)
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, LatencyHistogram] = {}
        for hist_name in HISTOGRAM_SEAMS.values():
            self._hists[hist_name] = LatencyHistogram(hist_name, owner=self)

    def counter(self, name: str) -> Counter:
        with self._lock:
            counter = self._counters.get(name)
            if counter is None:
                counter = self._counters[name] = Counter(name)
            return counter

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            gauge = self._gauges.get(name)
            if gauge is None:
                gauge = self._gauges[name] = Gauge(name)
            return gauge

    def histogram(self, name: str, eps: float = _HIST_EPS) -> LatencyHistogram:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = LatencyHistogram(name, eps=eps, owner=self)
            return hist

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {name: c.value for name, c in self._counters.items()}

    def gauges(self) -> Dict[str, float]:
        """Set gauges only (a never-set gauge has nothing to scrape)."""
        with self._lock:
            return {name: g.value for name, g in self._gauges.items() if g.value is not None}

    def histograms(self) -> Dict[str, LatencyHistogram]:
        with self._lock:
            return dict(self._hists)

    def snapshot(self, qs: Sequence[float] = DEFAULT_QUANTILES, quantiles: bool = True) -> Dict[str, Any]:
        """Plain data for exporters. ``quantiles=False`` is the light form
        (counts and sums only, no device read): what ``health_report()``
        embeds."""
        hists: Dict[str, Any] = {}
        for name, hist in self.histograms().items():
            if hist.count == 0:
                continue
            if quantiles:
                hists[name] = hist.snapshot(qs)
            else:
                hists[name] = {"count": hist.count, "sum_ms": hist.sum_ms, "eps": hist.eps}
        out: Dict[str, Any] = {"counters": self.counters(), "histograms": hists}
        gauges = self.gauges()
        if gauges:
            out["gauges"] = gauges
        return out

    def reset(self) -> None:
        """Test hook: drop every counter, gauge and histogram, re-seed the
        seam table (the fold device stays)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            for hist_name in HISTOGRAM_SEAMS.values():
                self._hists[hist_name] = LatencyHistogram(hist_name, owner=self)
        if self is registry:
            # the sink's memoized lookups point at the dropped objects
            _sink_counters.clear()
            _sink_hists.clear()
            _tier_seen.clear()
            _warn_once.reset()


registry = RuntimeMetrics()


def merged(*registries: RuntimeMetrics) -> RuntimeMetrics:
    """One registry covering every input's streams: counters add,
    histograms ``sketch_merge``, gauges last-write-wins in argument order.
    The result folds on the first input's ``fold_device``."""
    out = RuntimeMetrics(fold_device=registries[0].fold_device if registries else None)
    for reg in registries:
        for name, value in reg.counters().items():
            out.counter(name).inc(value)
        for name, value in reg.gauges().items():
            out.gauge(name).set(value)
        for name, hist in reg.histograms().items():
            if hist.count == 0:
                continue
            with out._lock:
                mine = out._hists.get(name)
                if mine is None or mine.count == 0:
                    empty = LatencyHistogram(name, eps=hist.eps, max_items=hist.max_items, device=hist.fold_device())
                    out._hists[name] = hist.merged(empty)
                else:
                    out._hists[name] = mine.merged(hist)
    return out


# distinct per-tier histograms allowed per kind: registry histograms are
# never evicted, so raw (unpadded) batch sizes would otherwise grow one
# sketch per distinct size for the life of the process
_TIER_HISTOGRAM_CAP = 64
_tier_seen: Dict[str, set] = {}


def observe_jit_wall(kind: str, rows: Optional[int], dur_ms: float) -> None:
    """One timed compiled-update call: feeds ``<kind>_ms`` and, when the
    call's padded row count is known, the per-ladder-tier
    ``<kind>_t{rows}_ms`` histogram. Callers gate on ``tracing_enabled()``.
    ``rows`` must be a ladder tier: past ``_TIER_HISTOGRAM_CAP`` distinct
    values per kind, new tiers observe into the base histogram only."""
    registry.histogram(f"{kind}_ms").observe(dur_ms)
    if rows is not None:
        seen = _tier_seen.setdefault(kind, set())
        if rows not in seen and len(seen) >= _TIER_HISTOGRAM_CAP:
            _warn_once(
                ("tier-cap", kind),
                f"observe_jit_wall({kind!r}): over {_TIER_HISTOGRAM_CAP} distinct "
                "row tiers observed — per-tier histograms are capped (rows should "
                "be padding-ladder tiers); further tiers fold into the base "
                f"{kind}_ms histogram only",
            )
            return
        seen.add(rows)
        registry.histogram(f"{kind}_t{rows}_ms").observe(dur_ms)


# span names whose occurrence counter is kept at the source (tracing on or
# off): the sink must not count their records twice
_COUNTED_AT_SOURCE = frozenset({"metric.jit_retrace"})


def note_jit_retrace(**attrs: Any) -> None:
    """One new compiled update of a metric: in the port, a CUDA-graph
    capture (JAX: a jit trace). Increments ``metric_jit_retrace_total``
    whether or not the tracer records, and fires the
    ``metric.jit_retrace`` instant when it does (the sink skips it)."""
    registry.counter("metric_jit_retrace_total").inc()
    from metrics_tpu_torch.obs.trace import instant

    instant("metric.jit_retrace", **attrs)


# memoized span-name -> Counter/LatencyHistogram lookups for the sink (it
# runs on the instrumented thread per record); registry.reset() clears both
_sink_counters: Dict[str, Counter] = {}
_sink_hists: Dict[str, Any] = {}  # name -> LatencyHistogram | None (not a seam)


def _trace_sink(name: str, dur_ns: int, attrs: Optional[Dict[str, Any]]) -> None:
    """The tracer sink: every record counts (except those counted at their
    source), seam spans also observe."""
    if name not in _COUNTED_AT_SOURCE:
        counter = _sink_counters.get(name)
        if counter is None:
            counter = _sink_counters[name] = registry.counter(name.replace(".", "_") + "_total")
        counter.inc()
    if dur_ns:
        hist = _sink_hists.get(name, False)
        if hist is False:
            seam = HISTOGRAM_SEAMS.get(name)
            hist = registry.histogram(seam) if seam is not None else None
            _sink_hists[name] = hist
        if hist is not None:
            hist.observe(dur_ns / 1e6)


# importing this module wires the sink; obs/__init__.py imports it, so the
# sink exists before the tracer can complete a record
from metrics_tpu_torch.obs.trace import add_trace_sink  # noqa: E402

add_trace_sink(_trace_sink)
