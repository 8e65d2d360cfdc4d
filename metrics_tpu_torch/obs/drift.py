"""Online drift detection (counterpart of ``metrics_tpu/obs/drift.py``):
score live traffic against a frozen reference through the streaming
sketches.

A :class:`ReferenceWindow` freezes the three sketches of a blessed traffic
period (``QuantileSketchState``, ``CountMinState``, ``HllState``); a
:class:`DriftMonitor` folds live traffic into the same three and, at each
check, scores the live window against the reference: ``ks`` (the largest
CDF gap over a probe grid of both sketches' quantiles), ``psi`` (over the
reference's quantile bins), ``hh_churn`` (Jaccard distance of the heavy
hitters, CountMin over a bounded candidate table) and ``cardinality_ratio``
(HLL against the count expected from the reference's fitted key universe).
A threshold crossing opens an episode with one ``drift_detected`` health
event (``trip_after`` breaching checks to enter, ``clear_after`` clean
ones to leave with ``drift_recovered``). Thresholds resolve programmatic >
``METRICS_TPU_DRIFT_*`` env > default, as in the JAX package.

**The monitor lives on a device** (``device=None`` means CUDA, as for a
metric), and the port keeps the request path free of reads:

- :meth:`DriftMonitor.observe` keeps the batch and its finite mask on the
  device and appends them to a pending list; it reads nothing back and
  returns the accepted-row count as a 0-d device tensor (stated difference
  D54: JAX returns a host int). Non-finite rows are counted as dropped when
  they fold. ``window_rows`` counts pending rows, finite or not, until then.
- The fold runs at a check (a reader), or in ``observe`` only when the
  pending rows pass ``_PENDING_DEVICE_CAP`` with no check between (one read
  then). It reads the pending batches' finite counts back once and replays
  the JAX package's fold exactly: the same fold groups (JAX folds inline
  once 32768 finite rows wait), the same 4096-row chunks padded to the same
  pow-2 tier with a ``valid`` mask, so the sketch states stay bit-equal to
  JAX's. The quantile sketch's chunks precompact in one batched sort
  (``ops/binning.py::precompact_binned`` along the last dimension) and
  fold one by one (one launch of kernel K3 each on the card); the CountMin
  and HLL updates are order-free (integer sums, register maxima) and take
  each fold group in one update.
- The heavy-hitter candidates come from the device: the fold group's keys
  are canonicalised through ``flush_denormals`` and sorted by the orderable
  key (W1: ``np.unique`` merges ``-0.0`` with ``+0.0``, ``torch.unique``
  does not), de-duplicated, queried in the live CountMin, and the top
  ``cap`` of each 4096-key chunk are kept, as JAX keeps them. Among keys of
  equal estimate at a chunk's cut the kept ones may differ from numpy's
  ``argpartition`` choice; the qualifying heavy hitters do not, unless more
  than ``cap`` keys of one chunk pass the bar (stated difference D57).
- The scoring (JAX's jitted ``_score_cdf_kernel``) runs in torch on the
  monitor's device; the scores and the candidates come back in one read.
  A check reads back twice: the finite counts, then the scores.

Its locks are the JAX package's named locks (``analysis/lockwitness.py``).
"""
import math
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.analysis.lockwitness import named_lock
from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError

Tensor = torch.Tensor

__all__ = [
    "ReferenceWindow",
    "DriftMonitor",
    "DRIFT_SCORES",
    "resolve_drift_threshold",
    "reset_drift_env_state",
]

# the four continuous scores every surface agrees on, in render order
DRIFT_SCORES: Tuple[str, ...] = ("ks", "psi", "hh_churn", "cardinality_ratio")

# --------------------------------------------------------------------------
# METRICS_TPU_DRIFT_* threshold knobs
# --------------------------------------------------------------------------

_DEFAULT_THRESHOLDS: Dict[str, float] = {
    "ks": 0.15,
    "psi": 0.25,  # the classic "major shift" PSI bar
    "hh_churn": 0.5,
    "cardinality_ratio": 2.0,  # fires at >= 2x or <= 0.5x distinct-rate
}

_ENV_VARS: Dict[str, str] = {
    "ks": "METRICS_TPU_DRIFT_KS",
    "psi": "METRICS_TPU_DRIFT_PSI",
    "hh_churn": "METRICS_TPU_DRIFT_HH_CHURN",
    "cardinality_ratio": "METRICS_TPU_DRIFT_CARDINALITY_RATIO",
}

_warn_once = WarnOnce()

# exclusive lower bound per score: the cardinality ratio breaches both ways
# (>= t or <= 1/t), so a t <= 1 would breach on every check
_THRESHOLD_FLOORS: Dict[str, float] = {"ks": 0.0, "psi": 0.0, "hh_churn": 0.0, "cardinality_ratio": 1.0}


def _threshold_parser(var: str, floor: float) -> Callable[[str], Optional[float]]:
    def parse(raw: str) -> Optional[float]:
        try:
            value = float(raw)
            # finite required: a NaN threshold slips every >= comparison
            if not math.isfinite(value) or value <= floor:
                raise ValueError(raw)
            return value
        except ValueError:
            _warn_once(
                (var, raw),
                f"{var}={raw!r} is not a finite number > {floor:g}; falling back "
                f"to the built-in default — drift detection keeps running untuned.",
            )
            return None

    return parse


_ENV: Dict[str, EnvParse] = {
    score: EnvParse(var, _threshold_parser(var, _THRESHOLD_FLOORS[score]), None) for score, var in _ENV_VARS.items()
}


def resolve_drift_threshold(score: str, programmatic: Optional[float]) -> float:
    """Programmatic arg > ``METRICS_TPU_DRIFT_*`` env > default (a malformed
    env value warns once and keeps the default)."""
    floor = _THRESHOLD_FLOORS[score]
    if programmatic is not None:
        if not math.isfinite(programmatic) or programmatic <= floor:
            raise MetricsTPUUserError(
                f"drift threshold {score!r} must be a finite value > {floor:g}, got {programmatic}"
                + (
                    " (the cardinality ratio breaches at >= t or <= 1/t, so any "
                    "t <= 1 would breach on EVERY check)"
                    if score == "cardinality_ratio"
                    else ""
                )
            )
        return float(programmatic)
    from_env = _ENV[score]()
    return from_env if from_env is not None else _DEFAULT_THRESHOLDS[score]


def reset_drift_env_state() -> None:
    """Test hook: forget memoized env parses and warn-once history."""
    _warn_once.reset()
    for env in _ENV.values():
        env.reset()


# --------------------------------------------------------------------------
# the live-window fold
# --------------------------------------------------------------------------


def fold_live_window(q_state: Any, cm_state: Any, hll_state: Any, values: Any, valid: Any = None):
    """Fold one batch into the three live-window sketches: ``(states,
    values[, valid])`` -> states. A ``valid`` False row changes nothing."""
    return (
        q_state.insert(values, valid),
        cm_state.insert(values, valid),
        hll_state.insert(values, valid),
    )


# one fold chunk: the JAX package's bound, and so its chunk boundaries
_PENDING_ROWS_CAP = 4096
# JAX folds inline once this many finite rows wait: the fold groups
_PENDING_HARD_CAP = 8 * _PENDING_ROWS_CAP
# the port folds in observe only past this many pending rows (one read)
_PENDING_DEVICE_CAP = 1 << 24

# probe-grid resolution for the KS scan (points per sketch)
_KS_GRID = 33

# floor under each PSI bin probability: an empty bin scores large but finite
_PSI_FLOOR = 1e-4


def _pad_rows(n: int) -> int:
    """The JAX package's pad tier of one fold chunk: pow-2, at least 64, at
    most the chunk bound (the halving level of a chunk depends on it)."""
    tier = 64
    while tier < n:
        tier <<= 1
    return min(tier, _PENDING_ROWS_CAP)


def _fit_universe(distinct: float, rows: float) -> float:
    """Key-universe size ``U`` solving ``distinct = U * (1 - exp(-rows /
    U))`` for the reference's observed pair (``inf`` for a continuous
    stream)."""
    if distinct >= rows:
        return math.inf
    lo, hi = max(distinct, 1.0), max(distinct, 1.0)
    fill = lambda u: u * (1.0 - math.exp(-rows / u))  # noqa: E731
    while fill(hi) < distinct:
        hi *= 2.0
        if hi > 1e15:
            return math.inf
    for _ in range(60):
        mid = (lo + hi) / 2.0
        if fill(mid) < distinct:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2.0


def _expected_distinct(universe: float, rows: float) -> float:
    return rows if math.isinf(universe) else universe * (1.0 - math.exp(-rows / universe))


def _compact(x: Tensor, keep: Tensor, n: int) -> Tensor:
    """The ``n`` kept rows of ``x`` in order, without a read back (``n`` is
    known): a scatter by the running count, the others into a spare slot."""
    if n == x.shape[0]:
        return x
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    idx = torch.where(keep, pos, torch.full_like(pos, n))
    out = torch.empty(n + 1, dtype=x.dtype, device=x.device)
    out.scatter_(0, idx, x)
    return out[:n]


# --------------------------------------------------------------------------
# ReferenceWindow: the frozen blessed-period baseline
# --------------------------------------------------------------------------


def _host(t: Any) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


class ReferenceWindow:
    """Frozen sketch trio from a blessed traffic period.

    Built by :meth:`DriftMonitor.freeze_reference`, or loaded from the
    ``to_primitives`` form (this package's or the JAX package's) with
    :meth:`from_primitives`. Immutable once constructed.
    """

    def __init__(
        self,
        quantile: Any,
        countmin: Any,
        hll: Any,
        hh_keys: Sequence[float] = (),
        rows: int = 0,
        captured_unix: Optional[float] = None,
    ) -> None:
        if rows <= 0:
            raise MetricsTPUUserError(f"a ReferenceWindow needs the blessed period's row count (> 0), got {rows}")
        self.quantile = quantile
        self.countmin = countmin
        self.hll = hll
        self.hh_keys = tuple(float(k) for k in hh_keys)
        self.rows = int(rows)
        self.captured_unix = float(captured_unix) if captured_unix is not None else time.time()

    @property
    def age_s(self) -> float:
        """Seconds since capture."""
        return max(0.0, time.time() - self.captured_unix)

    @property
    def device(self) -> torch.device:
        return self.quantile.items.device

    def to(self, device: Any) -> "ReferenceWindow":
        """This reference with its sketches on ``device`` (itself when they
        are there already)."""
        device = torch.device(device)
        if self.device == device:
            return self

        def move(state: Any) -> Any:
            return type(state)(*(t.to(device) for t in state))

        return ReferenceWindow(
            move(self.quantile), move(self.countmin), move(self.hll), self.hh_keys, self.rows, self.captured_unix
        )

    # -- serialization (the sketches' primitive forms, as host numpy) -----

    def to_primitives(self) -> Dict[str, Any]:
        return {
            "schema": "drift-reference-v1",
            "quantile": {k: _host(v) for k, v in self.quantile.to_primitives().items()},
            "countmin": {k: _host(v) for k, v in self.countmin.to_primitives().items()},
            "hll": {k: _host(v) for k, v in self.hll.to_primitives().items()},
            "hh_keys": np.asarray(self.hh_keys, np.float64),
            "rows": self.rows,
            "captured_unix": self.captured_unix,
        }

    @classmethod
    def from_primitives(cls, prim: Dict[str, Any], device: Any = None) -> "ReferenceWindow":
        """Load a ``to_primitives()`` mapping onto ``device`` (``None``:
        CUDA), refusing a malformed one by the field it names."""
        from metrics_tpu_torch.metric import resolve_device
        from metrics_tpu_torch.streaming.sketches import CountMinState, HllState, QuantileSketchState

        if not isinstance(prim, dict) or prim.get("schema") != "drift-reference-v1":
            raise MetricsTPUUserError(
                "ReferenceWindow loads from a to_primitives() mapping with "
                f"schema 'drift-reference-v1', got {type(prim).__name__}"
                + (f" (schema {prim.get('schema')!r})" if isinstance(prim, dict) else "")
            )
        q = prim["quantile"]
        items = np.asarray(q["items"])
        counts = np.asarray(q["counts"]).reshape(-1)
        if items.ndim != 2:
            raise MetricsTPUUserError(
                f"drift reference 'quantile.items' must be a 2-D (levels, k) array, got shape {items.shape}"
            )
        if counts.shape[0] != items.shape[0]:
            raise MetricsTPUUserError(
                f"drift reference 'quantile.counts' length {counts.shape[0]} != {items.shape[0]} sketch levels"
            )
        cm_counts = np.asarray(prim["countmin"]["counts"])
        if cm_counts.ndim != 2:
            raise MetricsTPUUserError(
                f"drift reference 'countmin.counts' must be a 2-D (depth, width) array, got shape {cm_counts.shape}"
            )
        registers = np.asarray(prim["hll"]["registers"]).reshape(-1)
        if registers.shape[0] < 16 or registers.shape[0] & (registers.shape[0] - 1):
            raise MetricsTPUUserError(
                f"drift reference 'hll.registers' length must be a power of two >= 16, got {registers.shape[0]}"
            )
        dev = resolve_device(device)

        def t(arr: Any, dtype: Any) -> Tensor:
            return torch.from_numpy(np.array(arr, dtype=dtype)).to(dev)

        qs = QuantileSketchState(
            items=t(items, np.float32),
            counts=t(counts, np.int32),
            n_seen=t(np.asarray(q.get("n_seen", 0)).reshape(()), np.int32),
        )
        cm = CountMinState(counts=t(cm_counts, np.int64))
        hll = HllState(registers=t(registers, np.int32))
        return cls(
            quantile=qs,
            countmin=cm,
            hll=hll,
            hh_keys=np.asarray(prim.get("hh_keys", ()), np.float64).reshape(-1).tolist(),
            rows=int(prim["rows"]),
            captured_unix=float(prim.get("captured_unix") or time.time()),
        )


# --------------------------------------------------------------------------
# DriftMonitor
# --------------------------------------------------------------------------


class _CohortRows(NamedTuple):
    """One cohort's rows of a request whose values or slice ids lie on the
    device: all rows with the cohort's mask (no boolean index, no read)."""

    values: Tensor
    keep: Tensor


class _Pending:
    """One observed batch waiting to fold: float32 rows on the device, the
    rows that count (finite, in the cohort), their 0-d count and the
    dropped (non-finite) rows' count; ``ok_host`` once read back."""

    __slots__ = ("x", "keep", "ok", "bad", "ok_host")

    def __init__(self, x: Tensor, keep: Tensor, ok: Tensor, bad: Tensor) -> None:
        self.x, self.keep, self.ok, self.bad = x, keep, ok, bad
        self.ok_host: Optional[int] = None


class DriftMonitor:
    """Score live traffic against a :class:`ReferenceWindow`, loudly.

    Example::

        mon = DriftMonitor("score", window=4096, device="cuda")
        for batch in blessed_traffic:
            mon.observe(batch)
        mon.set_reference(mon.freeze_reference())   # bless the baseline

        loop = ServeLoop(metric, drift_monitors=[mon])   # checks ride the
        ...                                              # reducer cadence
        loop.scrape()      # metrics_tpu_drift_ks{monitor="score"} ...

    ``extract`` maps one ``offer(*args, **kwargs)`` request to the watched
    values (default: the first positional argument). ``device`` is where
    the sketches live (``None``: CUDA).
    """

    def __init__(
        self,
        name: str,
        reference: Optional[ReferenceWindow] = None,
        *,
        window: int = 4096,
        min_rows: Optional[int] = None,
        eps: float = 0.05,
        cm_depth: int = 4,
        cm_width: int = 2048,
        hll_precision: int = 11,
        top_k: int = 16,
        hh_phi: float = 0.01,
        ks_threshold: Optional[float] = None,
        psi_threshold: Optional[float] = None,
        hh_churn_threshold: Optional[float] = None,
        cardinality_ratio_threshold: Optional[float] = None,
        trip_after: int = 1,
        clear_after: int = 2,
        extract: Optional[Callable[[tuple, dict], Any]] = None,
        slice_id: Optional[int] = None,
        slice_ids_key: str = "slice_ids",
        device: Any = None,
    ) -> None:
        from metrics_tpu_torch.metric import resolve_device

        if not name:
            raise MetricsTPUUserError("`name` must be a non-empty string")
        if slice_id is not None:
            if not isinstance(slice_id, int) or isinstance(slice_id, bool) or slice_id < 0:
                raise MetricsTPUUserError(f"`slice_id` must be a non-negative int cohort id, got {slice_id!r}")
            if not slice_ids_key:
                raise MetricsTPUUserError("`slice_ids_key` must be a non-empty kwarg name")
        if window < 2:
            raise MetricsTPUUserError(f"`window` must be >= 2 rows, got {window}")
        if min_rows is None:
            min_rows = max(2, window // 4)
        if not (2 <= min_rows <= window):
            raise MetricsTPUUserError(f"`min_rows` must be in [2, window={window}], got {min_rows}")
        if trip_after < 1 or clear_after < 1:
            raise MetricsTPUUserError(
                f"`trip_after`/`clear_after` must be >= 1 checks, got {trip_after}/{clear_after}"
            )
        if top_k < 1:
            raise MetricsTPUUserError(f"`top_k` must be >= 1, got {top_k}")
        if not (0.0 < hh_phi < 1.0):
            raise MetricsTPUUserError(f"`hh_phi` must be a frequency fraction in (0, 1), got {hh_phi}")
        # geometry is validated here, eagerly: the sketches build at the
        # first fold, which on a serving loop is the check cadence
        if not (0.0 < eps < 1.0):
            raise MetricsTPUUserError(f"`eps` must be in (0, 1), got {eps}")
        if cm_depth < 1:
            raise MetricsTPUUserError(f"`cm_depth` must be >= 1, got {cm_depth}")
        if cm_width < 2 or cm_width & (cm_width - 1):
            raise MetricsTPUUserError(f"`cm_width` must be a power of two >= 2, got {cm_width}")
        if not (4 <= hll_precision <= 18):
            raise MetricsTPUUserError(f"`hll_precision` must be in [4, 18], got {hll_precision}")
        self.name = name
        self.device = resolve_device(device)
        self.window = int(window)
        self.min_rows = int(min_rows)
        self.eps = float(eps)
        self.top_k = int(top_k)
        self.hh_phi = float(hh_phi)
        self.trip_after = int(trip_after)
        self.clear_after = int(clear_after)
        self.thresholds: Dict[str, float] = {
            "ks": resolve_drift_threshold("ks", ks_threshold),
            "psi": resolve_drift_threshold("psi", psi_threshold),
            "hh_churn": resolve_drift_threshold("hh_churn", hh_churn_threshold),
            "cardinality_ratio": resolve_drift_threshold("cardinality_ratio", cardinality_ratio_threshold),
        }
        self._geometry = dict(
            eps=float(eps), cm_depth=int(cm_depth), cm_width=int(cm_width), hll_precision=int(hll_precision)
        )
        self._extract = extract
        self.slice_id = slice_id
        self._slice_ids_key = slice_ids_key
        self._lock = named_lock("drift._lock", threading.RLock(), hot=True)
        # serializes whole check() passes; observe() takes _lock only
        self._check_lock = named_lock("drift._check_lock", threading.Lock(), hot=True)
        self._reference: Optional[ReferenceWindow] = None
        self._qgrid: Optional[np.ndarray] = None
        self._ref_edges: Optional[np.ndarray] = None
        self._ref_distinct = 0.0
        self._ref_universe = math.inf
        self._q: Any = None
        self._cm: Any = None
        self._hll: Any = None
        self._rows = 0
        self._pending: List[_Pending] = []
        self._pending_rows = 0  # rows of the pending batches, finite or not
        self._fold_gen = 0
        self._scored_gen = -1
        self._dropped_rows = 0
        self._candidates: Dict[float, int] = {}
        self._candidate_cap = max(4 * self.top_k, 64)
        # per fold group, the device buffers of its candidates, in fold
        # order, read back at the next check or freeze
        self._cand_buffers: List[Tuple[int, Tensor, Tensor]] = []
        # fold bookkeeping a caller may read: the quantile sketch's chunk
        # folds (one K3 launch each on the card) and the rows folded, over
        # every window
        self.fold_chunks = 0
        self.folded_rows = 0
        self._active = False
        self._breach_streak = 0
        self._clear_streak = 0
        self._checks = 0
        self._breaches = 0
        self._windows = 0
        self._detected_events = 0
        self._recovered_events = 0
        self._last_scores: Dict[str, Optional[float]] = {s: None for s in DRIFT_SCORES}
        self._last_breaching: Tuple[str, ...] = ()
        self._last_check_unix: Optional[float] = None
        if reference is not None:
            self.set_reference(reference)

    # -- reference lifecycle --------------------------------------------

    def set_reference(self, reference: ReferenceWindow) -> None:
        """Attach (or replace) the blessed baseline, refusing another
        geometry. Reads the reference's quantile edges and distinct count
        back once."""
        self._ensure_live_locked()
        with self._lock:
            if tuple(reference.quantile.items.shape) != tuple(self._q.items.shape):
                raise MetricsTPUUserError(
                    f"DriftMonitor {self.name!r}: reference quantile-sketch geometry "
                    f"{tuple(reference.quantile.items.shape)} != live {tuple(self._q.items.shape)}; "
                    "capture the reference with the same eps/window configuration"
                )
            if tuple(reference.countmin.counts.shape) != tuple(self._cm.counts.shape):
                raise MetricsTPUUserError(
                    f"DriftMonitor {self.name!r}: reference CountMin geometry "
                    f"{tuple(reference.countmin.counts.shape)} != live "
                    f"{tuple(self._cm.counts.shape)}; match cm_depth/cm_width"
                )
            if tuple(reference.hll.registers.shape) != tuple(self._hll.registers.shape):
                raise MetricsTPUUserError(
                    f"DriftMonitor {self.name!r}: reference HLL geometry "
                    f"{tuple(reference.hll.registers.shape)} != live "
                    f"{tuple(self._hll.registers.shape)}; match hll_precision"
                )
            reference = reference.to(self.device)
            self._reference = reference
            grid = np.linspace(1.0 / _KS_GRID, 1.0 - 1.0 / _KS_GRID, _KS_GRID - 1)
            self._qgrid = np.asarray(grid, np.float32)
            self._ref_edges = _host(reference.quantile.quantile(torch.from_numpy(self._qgrid))).astype(np.float32)
            self._ref_distinct = float(reference.hll.estimate())
            self._ref_universe = _fit_universe(self._ref_distinct, float(reference.rows))
            self._fold_gen += 1  # a new baseline: the next check rescores
        from metrics_tpu_torch.resilience.health import record_degradation

        record_degradation(
            "drift_baseline_loaded",
            f"drift monitor {self.name!r} loaded a reference window "
            f"({reference.rows} blessed rows, captured {reference.age_s:.0f}s ago)",
            monitor=self.name,
            reference_rows=reference.rows,
        )

    def load_reference(self, prim: Dict[str, Any]) -> ReferenceWindow:
        """``from_primitives`` (on this monitor's device) and
        :meth:`set_reference` in one call."""
        reference = ReferenceWindow.from_primitives(prim, device=self.device)
        self.set_reference(reference)
        return reference

    def freeze_reference(self) -> ReferenceWindow:
        """Freeze the current live window as a blessed baseline (the pending
        rows fold first). The live window keeps accumulating: call
        :meth:`rotate` after freezing when the blessed rows should not also
        be scored as live traffic."""
        with self._lock:
            self._fold_pending_locked()
            self._settle_candidates_locked()
            if self._rows < 2:
                raise MetricsTPUUserError(
                    f"DriftMonitor {self.name!r}: cannot freeze a reference from "
                    f"{self._rows} observed rows — stream the blessed period through "
                    "observe() first"
                )
            return ReferenceWindow(
                quantile=self._q, countmin=self._cm, hll=self._hll, hh_keys=self._top_keys_locked(), rows=self._rows
            )

    # -- live window ----------------------------------------------------

    def _ensure_live_locked(self) -> None:
        if self._q is not None:
            return
        from metrics_tpu_torch.streaming.sketches import CountMinState, HllState, QuantileSketchState

        with self._lock:
            if self._q is None:
                g = self._geometry
                # max_items is generous (not the window), so one geometry
                # also absorbs a blessed period of any realistic length
                self._q = QuantileSketchState.create(
                    eps=g["eps"], max_items=max(1 << 20, 8 * self.window), device=self.device
                )
                self._cm = CountMinState.create(depth=g["cm_depth"], width=g["cm_width"], device=self.device)
                self._hll = HllState.create(precision=g["hll_precision"], device=self.device)

    def _rows_tensor(self, values: Any) -> Tensor:
        """The watched values as a flat tensor on the monitor's device; a
        host array goes through float64, as the JAX package reads it."""
        if isinstance(values, Tensor):
            x = values.detach().reshape(-1)
        else:
            x = torch.from_numpy(np.asarray(values, np.float64).reshape(-1))
        return x.to(self.device)

    def observe(self, values: Any) -> Tensor:
        """Append one batch of the watched values to the live window. Reads
        nothing back: returns the accepted (finite) row count as a 0-d
        int64 tensor on the monitor's device (D54). Non-numeric input is
        counted as one dropped row and never raises."""
        keep = None
        try:
            if isinstance(values, _CohortRows):
                x, keep = self._rows_tensor(values.values), self._rows_tensor(values.keep).to(torch.bool)
            else:
                x = self._rows_tensor(values)
            if x.is_complex():
                raise TypeError(f"cannot watch a {x.dtype} batch")
        except (TypeError, ValueError, RuntimeError):
            with self._lock:
                self._dropped_rows += 1
            return torch.zeros((), dtype=torch.int64, device=self.device)
        if x.shape[0] == 0:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        finite = torch.isfinite(x) if x.is_floating_point() else torch.ones_like(x, dtype=torch.bool)
        cohort = keep if keep is not None else torch.ones_like(finite)
        ok_mask = finite & cohort
        ok = torch.sum(ok_mask, dtype=torch.int64)
        bad = torch.sum(cohort & ~finite, dtype=torch.int64)
        entry = _Pending(x.to(torch.float32), ok_mask, ok, bad)
        with self._lock:
            self._pending.append(entry)
            self._pending_rows += int(x.shape[0])
            if self._pending_rows >= _PENDING_DEVICE_CAP:
                # a burst with no check between: fold the complete groups
                self._fold_pending_locked(final=False)
        return ok

    def extract_from(self, args: tuple, kwargs: dict) -> Any:
        """The values this monitor watches out of one request's ``(*args,
        **kwargs)``: the ``extract`` hook when configured, else the first
        positional argument (``None``: nothing to observe). With
        ``slice_id``, only the rows whose ``slice_ids`` kwarg matches (and
        whose ``valid`` mask is True): host arrays are filtered as JAX
        filters them (``None`` when no row is left), device tensors keep
        every row under a mask, which :meth:`observe` honours (D54)."""
        if self._extract is not None:
            values = self._extract(args, kwargs)
        else:
            values = args[0] if args else None
        if self.slice_id is None or values is None:
            return values
        ids = kwargs.get(self._slice_ids_key)
        if ids is None:
            return None
        valid = kwargs.get("valid")
        if any(isinstance(v, Tensor) for v in (values, ids, valid)):
            try:
                vals = self._rows_tensor(values)
                idt = self._rows_tensor(ids)
            except (TypeError, ValueError, RuntimeError):
                return None
            if vals.shape[0] != idt.shape[0]:
                return None
            mask = idt == self.slice_id
            if valid is not None:
                try:
                    vmask = self._rows_tensor(valid).to(torch.bool)
                except (TypeError, ValueError, RuntimeError):
                    return None
                if vmask.shape[0] != mask.shape[0]:
                    return None
                mask = mask & vmask
            return _CohortRows(vals, mask)
        try:
            vals = np.asarray(values, np.float64).reshape(-1)
            idarr = np.asarray(ids, np.int64).reshape(-1)
        except (TypeError, ValueError):
            return None
        if vals.shape[0] != idarr.shape[0]:
            return None
        mask = idarr == self.slice_id
        if valid is not None:
            try:
                vmask = np.asarray(valid, bool).reshape(-1)
            except (TypeError, ValueError):
                return None
            if vmask.shape[0] != mask.shape[0]:
                return None
            mask &= vmask
        out = vals[mask]
        return out if out.size else None

    def _fold_pending_locked(self, final: bool = True) -> None:
        """Fold the pending batches as the JAX package would have: in the
        groups its inline folds make (``final``: the last, partial group
        too, as its check folds it; else it stays pending)."""
        if not self._pending:
            return
        self._ensure_live_locked()
        fresh = [e for e in self._pending if e.ok_host is None]
        if fresh:
            # the one read back of a fold: every new batch's two counts
            counts = torch.stack([e.ok for e in fresh] + [e.bad for e in fresh]).tolist()
            for e, ok, bad in zip(fresh, counts[: len(fresh)], counts[len(fresh):]):
                e.ok_host = int(ok)
                self._dropped_rows += int(bad)
        groups: List[List[_Pending]] = []
        cur: List[_Pending] = []
        run = 0
        for e in self._pending:
            if e.ok_host == 0:
                continue  # JAX appends nothing for it
            cur.append(e)
            run += e.ok_host
            if run >= _PENDING_HARD_CAP:
                groups.append(cur)
                cur, run = [], 0
        if final and cur:
            groups.append(cur)
            cur = []
        self._pending = cur
        self._pending_rows = sum(int(e.x.shape[0]) for e in cur)
        for group in groups:
            batch = torch.cat([_compact(e.x, e.keep, e.ok_host) for e in group])
            self._fold_group(batch)

    def _fold_group(self, batch: Tensor) -> None:
        """One JAX fold of ``batch`` (the group's accepted rows): the
        sketches by 4096-row chunks, then the group's candidates."""
        n = int(batch.shape[0])
        q = self._q
        k = q.items.shape[1]
        full = n // _PENDING_ROWS_CAP
        rest = n - full * _PENDING_ROWS_CAP
        from metrics_tpu_torch.ops.binning import precompact_binned
        from metrics_tpu_torch.ops.compactor import fold_cascade

        if full:
            # a chunk's halving level stays below the top level: the live
            # geometry holds at least 2**20 items
            chunks = batch[: full * _PENDING_ROWS_CAP].reshape(full, _PENDING_ROWS_CAP)
            inc, inc_count, level = precompact_binned(chunks, torch.ones_like(chunks, dtype=torch.bool), k)
            items, counts = q.items, q.counts
            for c in range(full):
                items, counts = fold_cascade(items, counts, inc[c], inc_count[c], level)
            # each chunk adds its finite rows, as QuantileSketchState.insert does
            n_seen = q.n_seen + torch.sum(torch.isfinite(chunks), dtype=torch.int32)
            q = type(q)(items=items, counts=counts, n_seen=n_seen)
        if rest:
            tier = _pad_rows(rest)
            vals = torch.zeros(tier, dtype=torch.float32, device=batch.device)
            vals[:rest] = batch[full * _PENDING_ROWS_CAP :]
            valid = torch.arange(tier, device=batch.device) < rest
            q = q.insert(vals, valid)
        self.fold_chunks += full + (1 if rest else 0)
        # the CountMin sums and the HLL maxima do not depend on the chunking
        self._q, self._cm, self._hll = q, self._cm.insert(batch), self._hll.insert(batch)
        self._rows += n
        self.folded_rows += n
        self._fold_gen += 1
        self._cand_buffers.append(self._candidate_buffer(batch))

    def _candidate_buffer(self, batch: Tensor) -> Tuple[int, Tensor, Tensor]:
        """The group's heavy-hitter candidates on the device: its distinct
        keys (canonical: ``-0.0`` and denormals as ``+0.0``), re-scored by
        the live CountMin, the top ``cap`` of each 4096-key chunk (by
        estimate, then key) in ``(chunks, cap)`` slots; an empty slot has
        estimate -1."""
        from metrics_tpu_torch.ops.binning import _SIGN32, key_to_float32
        from metrics_tpu_torch.ops.bucketed_rank import _float32_ascending_key, flush_denormals

        n = int(batch.shape[0])
        cap = self._candidate_cap
        n_chunks = -(-n // _PENDING_ROWS_CAP)
        keys = torch.sort(_float32_ascending_key(flush_denormals(batch))).values
        first = torch.ones(n, dtype=torch.bool, device=batch.device)
        first[1:] = keys[1:] != keys[:-1]
        vals = key_to_float32(keys.to(torch.int64) + _SIGN32)
        est = self._cm.query(vals)
        chunk = (torch.cumsum(first.to(torch.int64), 0) - 1) // _PENDING_ROWS_CAP
        # within each chunk: estimate descending, then key ascending (the
        # stable sort keeps the key order of equal estimates)
        order = torch.sort(est, descending=True, stable=True).indices
        sentinel = torch.full_like(chunk, n_chunks)
        grouped = torch.where(first, chunk, sentinel)[order]
        order = order[torch.sort(grouped, stable=True).indices]
        c_sorted = torch.where(first, chunk, sentinel)[order]
        within = torch.arange(n, device=batch.device) - c_sorted * _PENDING_ROWS_CAP
        take = (c_sorted < n_chunks) & (within < cap)
        slot = torch.where(take, c_sorted * cap + within, n_chunks * cap)
        out_keys = torch.full((n_chunks * cap + 1,), float("nan"), dtype=torch.float32, device=batch.device)
        out_est = torch.full((n_chunks * cap + 1,), -1, dtype=torch.int64, device=batch.device)
        out_keys.scatter_(0, slot, vals[order])
        out_est.scatter_(0, slot, est[order])
        return n_chunks, out_keys[:-1], out_est[:-1]

    def _apply_candidates_locked(self, host: List[Tuple[int, np.ndarray, np.ndarray]]) -> None:
        """Replay JAX's candidate-table updates, one fold group at a time."""
        cap = self._candidate_cap
        for n_chunks, keys, est in host:
            keys = keys.reshape(n_chunks, cap)
            est = est.reshape(n_chunks, cap)
            for c in range(n_chunks):
                for key, count in zip(keys[c].tolist(), est[c].tolist()):
                    if count >= 0:
                        self._candidates[float(key)] = int(count)
            if len(self._candidates) > cap:
                keep = sorted(self._candidates.items(), key=lambda kv: -kv[1])
                self._candidates = dict(keep[:cap])

    def _settle_candidates_locked(self) -> None:
        """Read the waiting candidate buffers back and apply them."""
        if not self._cand_buffers:
            return
        buffers, self._cand_buffers = self._cand_buffers, []
        flat = torch.cat([torch.cat([k.to(torch.float64), e.to(torch.float64)]) for _, k, e in buffers]).cpu().numpy()
        self._apply_candidates_locked(_split_candidates(buffers, flat))

    def _hh_min_count(self, rows: int) -> int:
        """The phi-heavy-hitter bar of a ``rows``-row window (at least 2)."""
        return max(2, int(math.ceil(self.hh_phi * rows)))

    def _top_keys_locked(self, rows: Optional[int] = None) -> Tuple[float, ...]:
        """Top-``top_k`` candidate keys that qualify as heavy hitters."""
        bar = self._hh_min_count(self._rows if rows is None else rows)
        top = sorted(
            ((key, count) for key, count in self._candidates.items() if count >= bar),
            key=lambda kv: (-kv[1], kv[0]),
        )[: self.top_k]
        return tuple(key for key, _count in top)

    def _rotate_locked(self) -> None:
        """The one bucket reset of :meth:`rotate` and the check's rotation."""
        self._q = self._cm = self._hll = None
        self._rows = 0
        self._candidates = {}
        self._cand_buffers = []
        self._windows += 1
        self._fold_gen += 1

    def rotate(self) -> None:
        """Start a fresh live bucket (sketches reset; the episode carries
        over)."""
        with self._lock:
            self._fold_pending_locked()
            self._rotate_locked()

    @property
    def window_rows(self) -> int:
        """Rows in the live bucket, pending rows included (finite or not
        until they fold)."""
        with self._lock:
            return self._rows + self._pending_rows

    @property
    def dropped_rows(self) -> int:
        """Non-finite and non-numeric rows counted so far (a pending batch's
        count once it folds)."""
        with self._lock:
            return self._dropped_rows

    # -- scoring --------------------------------------------------------

    def score_floor(self) -> Dict[str, float]:
        """The sketch-error floor under the CDF scores: a KS or per-bin PSI
        probability is uncertain by ``eps_live + eps_ref`` rank mass."""
        eps_live = self._q.eps_bound if self._q is not None else self._geometry["eps"]
        eps_ref = self._reference.quantile.eps_bound if self._reference is not None else self._geometry["eps"]
        eps_total = float(eps_live) + float(eps_ref)
        return {"ks": eps_total, "psi_bin_probability": 2.0 * eps_total}

    def _score_tensors(self, live_q: Any, live_hll: Any, ref: ReferenceWindow, ref_edges: np.ndarray, qgrid: np.ndarray) -> Tensor:
        """JAX's ``_score_cdf_kernel`` and the live HLL estimate on the
        device, as one float64 vector: ``[ks, live_edge..., ref_edge...,
        live_distinct]``."""
        dev = live_q.items.device
        edges = torch.from_numpy(ref_edges).to(dev)
        live_edges = live_q.quantile(torch.from_numpy(qgrid).to(dev))
        probes = torch.cat([edges, live_edges])
        ks = torch.max(torch.abs(live_q.cdf(probes) - ref.quantile.cdf(probes)))
        return torch.cat(
            [
                ks.reshape(1).to(torch.float64),
                live_q.cdf(edges).to(torch.float64),
                ref.quantile.cdf(edges).to(torch.float64),
                live_hll.estimate().reshape(1).to(torch.float64),
            ]
        )

    def _scores_from(self, host: np.ndarray, live_top: set, rows: int, ref: ReferenceWindow) -> Dict[str, Optional[float]]:
        """The four scores from the read-back vector, on the host."""
        scores: Dict[str, Optional[float]] = {s: None for s in DRIFT_SCORES}
        m = (host.shape[0] - 2) // 2
        scores["ks"] = float(np.float32(host[0]))
        live_edge = host[1 : 1 + m]
        ref_edge = host[1 + m : 1 + 2 * m]
        p_live = np.diff(np.concatenate([[0.0], np.sort(live_edge), [1.0]]))
        p_ref = np.diff(np.concatenate([[0.0], np.sort(ref_edge), [1.0]]))
        p_live = np.maximum(p_live, _PSI_FLOOR)
        p_ref = np.maximum(p_ref, _PSI_FLOOR)
        p_live /= p_live.sum()
        p_ref /= p_ref.sum()
        scores["psi"] = float(np.sum((p_live - p_ref) * np.log(p_live / p_ref)))
        if ref.hh_keys:
            ref_top = set(ref.hh_keys)
            union = live_top | ref_top
            if union:
                scores["hh_churn"] = 1.0 - len(live_top & ref_top) / len(union)
        live_distinct = float(host[-1])
        if self._ref_distinct > 0 and rows > 0:
            expected = _expected_distinct(self._ref_universe, float(rows))
            scores["cardinality_ratio"] = float(max(live_distinct, 1.0) / max(expected, 1.0))
        return scores

    def _breaching(self, scores: Dict[str, Optional[float]]) -> Tuple[str, ...]:
        out = []
        for key in ("ks", "psi", "hh_churn"):
            value = scores.get(key)
            if value is not None and value >= self.thresholds[key]:
                out.append(key)
        ratio = scores.get("cardinality_ratio")
        bar = self.thresholds["cardinality_ratio"]
        if ratio is not None and (ratio >= bar or ratio <= 1.0 / bar):
            out.append("cardinality_ratio")
        return tuple(out)

    # -- the check (the reducer-cadence entry point) --------------------

    def check(self) -> Dict[str, Any]:
        """One drift check: fold the pending rows, score the live bucket
        against the reference (when both are ready), walk the hysteresis
        state machine, rotate a full bucket; returns :meth:`status`. Two
        reads back: the pending batches' finite counts, then the scores
        with the heavy-hitter candidates."""
        events: List[Tuple[str, str, Dict[str, Any]]] = []
        with self._check_lock:
            # phase 1 (under the monitor lock): fold, snapshot the states
            with self._lock:
                self._fold_pending_locked()
                ref = self._reference
                rows = self._rows
                scored = ref is not None and rows >= self.min_rows and self._fold_gen != self._scored_gen
                fold_gen = self._fold_gen
                live_q, live_hll = self._q, self._hll
                buffers, self._cand_buffers = self._cand_buffers, []
                ref_edges, qgrid = self._ref_edges, self._qgrid
            # phase 2 (no lock: observe() never waits behind the scoring):
            # the scores and the candidates come back in one read
            parts = [torch.cat([k.to(torch.float64), e.to(torch.float64)]) for _, k, e in buffers]
            if scored:
                parts.append(self._score_tensors(live_q, live_hll, ref, ref_edges, qgrid))
            host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0)
            cand_host = _split_candidates(buffers, host)
            # phase 3 (under the lock): candidates, verdict, rotation
            with self._lock:
                self._apply_candidates_locked(cand_host)
                if scored:
                    live_top = set(self._top_keys_locked())
                    tail = sum(2 * n * self._candidate_cap for n, _, _ in buffers)
                    scores = self._scores_from(host[tail:], live_top, rows, ref)
                    breaching = self._breaching(scores)
                    # committed only now: a failed scoring leaves the
                    # generation unscored, so the next check retries
                    self._scored_gen = fold_gen
                    self._checks += 1
                    self._last_check_unix = time.time()
                    self._last_scores = scores
                    self._last_breaching = breaching
                    if breaching:
                        self._breaches += 1
                        self._breach_streak += 1
                        self._clear_streak = 0
                        if not self._active and self._breach_streak >= self.trip_after:
                            self._active = True
                            self._detected_events += 1
                            detail = {k: round(scores[k], 4) for k in breaching if scores[k] is not None}
                            events.append(
                                (
                                    "drift_detected",
                                    f"drift monitor {self.name!r}: {', '.join(breaching)} crossed "
                                    f"threshold over the last {rows} rows "
                                    f"(scores {detail}, thresholds "
                                    f"{ {k: self.thresholds[k] for k in breaching} })",
                                    {
                                        "monitor": self.name,
                                        "breaching": list(breaching),
                                        "scores": detail,
                                        "window_rows": rows,
                                    },
                                )
                            )
                    else:
                        self._clear_streak += 1
                        self._breach_streak = 0
                        if self._active and self._clear_streak >= self.clear_after:
                            self._active = False
                            self._recovered_events += 1
                            events.append(
                                (
                                    "drift_recovered",
                                    f"drift monitor {self.name!r}: all scores back under "
                                    f"threshold for {self._clear_streak} consecutive checks",
                                    {"monitor": self.name},
                                )
                            )
                if self._rows >= self.window:
                    self._rotate_locked()
                status = self._status_locked()
        # events record outside the lock: the health registry has its own
        from metrics_tpu_torch.resilience.health import record_degradation

        for kind, message, details in events:
            record_degradation(kind, message, **details)
        return status

    # -- status / export surfaces ---------------------------------------

    def _status_locked(self) -> Dict[str, Any]:
        ref = self._reference
        return {
            "name": self.name,
            "slice": self.slice_id,
            "active": self._active,
            "scores": dict(self._last_scores),
            "breaching": list(self._last_breaching),
            "thresholds": dict(self.thresholds),
            "window": self.window,
            "window_rows": self._rows + self._pending_rows,
            "min_rows": self.min_rows,
            "windows": self._windows,
            "checks": self._checks,
            "breaches": self._breaches,
            "dropped_rows": self._dropped_rows,
            "detected_events": self._detected_events,
            "recovered_events": self._recovered_events,
            "last_check_unix": self._last_check_unix,
            "reference": (
                None
                if ref is None
                else {"rows": ref.rows, "captured_unix": ref.captured_unix, "age_s": ref.age_s, "hh_keys": len(ref.hh_keys)}
            ),
        }

    def status(self) -> Dict[str, Any]:
        """Plain data for ``health()`` and the exporters (host only)."""
        with self._lock:
            return self._status_locked()

    def fleet_scores(self) -> Dict[str, Any]:
        """The compact per-host form: the four scores and the episode flag."""
        with self._lock:
            out: Dict[str, Any] = {k: (None if v is None else round(float(v), 6)) for k, v in self._last_scores.items()}
            out["active"] = self._active
            out["windows"] = self._windows
            if self.slice_id is not None:
                out["slice"] = self.slice_id
            return out


def _split_candidates(buffers: List[Tuple[int, Tensor, Tensor]], host: np.ndarray) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """The read-back candidate buffers, group by group, out of ``host``."""
    out = []
    at = 0
    for n_chunks, keys, _est in buffers:
        size = keys.shape[0]
        out.append((n_chunks, host[at : at + size].astype(np.float32), host[at + size : at + 2 * size].astype(np.int64)))
        at += 2 * size
    return out
