"""Per-cohort metrics from one update (counterpart of
``metrics_tpu/sliced/slicing.py``).

:class:`SlicedMetric` threads a slice axis of ``K`` cohorts through a
metric's states: every ``update`` takes a ``slice_ids`` vector (one id per
row) beside the metric's own arguments and folds every slice at once.

**State layout.** For each state ``name`` of the wrapped metric a ring
``sl__{name}`` with a leading axis of ``K + 2``:

- rows ``0..K-1``, the slices;
- row ``K``, the quarantine: valid rows whose slice id lies outside
  ``[0, K)``, counted and kept out of every slice;
- row ``K + 1``, the discard: rows masked invalid (``valid`` False, the
  padding ladder's pad rows among them), so a pad row reaches no slice
  even when the wrapped metric cannot consume a row mask.

``sl__rows`` counts the rows of each. A mean state's ring holds sums of the
per-row deltas, divided by the slice's rows when read.

**Update.** The wrapped update runs once per row on a fresh state, all rows
at once under ``torch.func.vmap`` (the guard included, the value checks
off, as in a traced update), and the per-row deltas go into the rings by
segment: ``index_add`` for sum, mean, fault-counter and CountMin states,
``scatter_reduce`` ``amax``/``amin`` for max, min and HyperLogLog states.
The work grows with the batch, not with ``K``. Integer rings are exact;
float sums (``index_add`` on the card adds with atomics) run in another
order than the JAX package's ``segment_sum``.

**Supported states**: tensors reduced by sum, mean, max or min, the fault
counters (the fault channel becomes per-slice) and the elementwise
sketches (CountMin: sum; HyperLogLog: max). Refused, as in the JAX
package: quantile sketches (their merge is a compaction), list and ring
states, and an inner trace-safe wrapper (compose
``WindowedMetric(SlicedMetric(m))`` instead).

**Kernel-backed members.** A wrapped metric whose update launches a kernel
(the Binned metrics' K1, the confusion matrix family's K2 through
``_bincount``) slices on the card as on the CPU: under ``vmap`` each
kernel's wrapper takes its lane route (``ops/_build.py::lane_route``), and
the update's rows become the lanes of one launch of the kernel's
lane-batched form, as ``pallas_call``'s batching rule gives the JAX package
one batched kernel. The per-row deltas are materialised, as JAX's ``vmap``
materialises them: ``(n, *state)`` beside the ``(K + 2, *state)`` rings
(ROADMAP Queue 2 parks counting straight into the rings). Their rings hold
integer counts (float32 counts of 0/1 rows for the Binned metrics) and stay
bit-equal to the JAX package's.

**Scrape.** :meth:`SlicedMetric.scrape_slices` gives the top slices by rows
(at most ``METRICS_TPU_SLICES_MAX_LABELS``, default 8) with their scalar
values, and the tail as one ``other`` bucket.
"""
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce
from metrics_tpu_torch.ops.padding import SLICE_STATE_PREFIX
from metrics_tpu_torch.streaming.windowed import _StreamingWrapper
from metrics_tpu_torch.utilities.checks import value_checks_off
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utilities.guard import FaultCounters
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer

Tensor = torch.Tensor

__all__ = ["SlicedMetric", "SlicedValue", "slices_max_labels", "reset_sliced_state"]

_MAX_LABELS_VAR = "METRICS_TPU_SLICES_MAX_LABELS"
_MAX_LABELS_DEFAULT = 8
_SUM_KINDS = ("sum", "mean", "faults", "sketch_sum")

_warn_once = WarnOnce()


def _parse_max_labels(raw: str) -> int:
    try:
        n = int(raw)
        if n < 1:
            raise ValueError
        return n
    except ValueError:
        _warn_once(
            ("max-labels-malformed", raw),
            f"{_MAX_LABELS_VAR}={raw!r} is malformed (expected a positive integer); "
            f"falling back to the default cap of {_MAX_LABELS_DEFAULT}",
        )
        return _MAX_LABELS_DEFAULT


_max_labels_env: "EnvParse[int]" = EnvParse(_MAX_LABELS_VAR, _parse_max_labels, _MAX_LABELS_DEFAULT)


def slices_max_labels() -> int:
    """The cap on per-slice scrape rows (``METRICS_TPU_SLICES_MAX_LABELS``,
    default 8); a malformed value warns once and keeps the default."""
    return _max_labels_env()


def reset_sliced_state() -> None:
    """Forget the warnings given and the memoized parse (for tests)."""
    _warn_once.reset()
    _max_labels_env.reset()


class SlicedValue(NamedTuple):
    """A :class:`SlicedMetric`'s value: the wrapped metric's value with a
    ``(K,)`` leading axis, the rollup over the slices, and the quarantined
    rows. A NamedTuple, so a collection keeps it under its member key."""

    per_slice: Any
    global_value: Any
    quarantined_rows: Any


def _value_leaves(value: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, tensor)`` of a computed value (dicts by key, sequences by
    ``[i]``), the JAX package's tree-path names; a bare tensor is
    ``value``."""
    if isinstance(value, dict):
        return [leaf for k, v in value.items() for leaf in _value_leaves(v, f"{path}/{k}" if path else str(k))]
    if isinstance(value, (list, tuple)):
        return [leaf for i, v in enumerate(value) for leaf in _value_leaves(v, f"{path}/[{i}]" if path else f"[{i}]")]
    return [(path or "value", value)]


class SlicedMetric(_StreamingWrapper):
    """A metric's value per slice, from one update over ``K`` cohorts.

    ``update(*args, slice_ids=ids, valid=None, **kwargs)`` takes one slice
    id per row; ``compute()`` returns a :class:`SlicedValue`. An empty
    slice computes what a fresh instance of the wrapped metric computes.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SlicedMetric, SumMetric
        >>> m = SlicedMetric(SumMetric(device="cpu"), num_slices=2)
        >>> m.update(torch.tensor([1.0, 2.0, 4.0]), slice_ids=torch.tensor([0, 1, 1]))
        >>> out = m.compute()
        >>> [float(v) for v in out.per_slice], float(out.global_value)
        ([1.0, 6.0], 7.0)
    """

    _KIND_NAME = "sliced"
    # the wrapper consumes ``valid`` itself: masked rows go to the discard
    _valid_mask_always = True

    def __init__(self, metric: Metric, num_slices: int, **kwargs: Any) -> None:
        super().__init__(metric, **kwargs)
        if not (isinstance(num_slices, int) and num_slices >= 1):
            raise ValueError(f"`num_slices` must be a positive int, got {num_slices}")
        if getattr(metric, "_wrapper_trace_safe", False):
            raise ValueError(
                f"SlicedMetric cannot wrap {type(metric).__name__}: the inner wrapper's ring "
                "bookkeeping (bucket heads, fill counters) has no per-row delta form. Compose "
                "the other way — e.g. WindowedMetric(SlicedMetric(m), ...) windows every slice."
            )
        self.num_slices = num_slices
        self._specs = self._sliced_state_specs()

        R = num_slices + 2  # the slices, the quarantine and the discard
        for name, kind in self._specs.items():
            identity = self._leaf(name, self.wrapped._defaults[name]).to(self.device)
            # mean rings hold sums: exact over processes with no count
            fx = "max" if kind in ("max", "sketch_max") else "min" if kind == "min" else "sum"
            ring = identity.unsqueeze(0).repeat((R,) + (1,) * identity.ndim)
            self.add_state(f"{SLICE_STATE_PREFIX}{name}", default=ring, dist_reduce_fx=fx)
        self.add_state(f"{SLICE_STATE_PREFIX}rows", default=torch.zeros((R,), dtype=torch.int32), dist_reduce_fx="sum")

    # ------------------------------------------------------------------
    # state specs
    # ------------------------------------------------------------------

    def _sliced_state_specs(self) -> Dict[str, str]:
        """``{state: kind}``, kind one of sum, mean, max, min, faults,
        sketch_sum and sketch_max; raises for a state with no segment
        reduction."""
        specs: Dict[str, str] = {}
        child = type(self.wrapped).__name__
        for name, default in self.wrapped._defaults.items():
            fx = self.wrapped._reductions[name]
            if isinstance(default, FaultCounters):
                specs[name] = "faults"
            elif getattr(type(default), "is_sketch_state", False):
                er = getattr(type(default), "elementwise_reduction", None)
                if er not in ("sum", "max"):
                    raise ValueError(
                        f"SlicedMetric cannot wrap {child}: state {name!r} is a "
                        f"{type(default).__name__} whose merge is compaction, not an "
                        "elementwise reduce — it has no (K,)-ring form. Slice the "
                        "elementwise sketches (CountMinSketch, HyperLogLog) or keep "
                        "quantile sketches unsliced."
                    )
                if len(default) != 1:
                    raise ValueError(
                        f"SlicedMetric cannot wrap {child}: sketch state {name!r} has "
                        "multiple leaves; only single-leaf elementwise sketches slice."
                    )
                specs[name] = f"sketch_{er}"
            elif isinstance(default, (list, CatBuffer)):
                raise ValueError(
                    f"SlicedMetric cannot wrap {child}: state {name!r} is a per-row "
                    "cat/list state with no per-slice segment-reduce form. Construct "
                    "the metric in a binned/fixed-shape variant to slice it."
                )
            elif fx in ("sum", "mean", "max", "min"):
                specs[name] = fx
            else:
                raise ValueError(
                    f"SlicedMetric cannot wrap {child}: state {name!r} has "
                    f"dist_reduce_fx={fx!r}, which has no segment-reduce rule."
                )
        return specs

    def _leaf(self, name: str, value: Any) -> Tensor:
        """A child state's one tensor: the counts of the fault counters, the
        single field of an elementwise sketch."""
        kind = self._specs[name]
        if kind == "faults":
            return value.counts
        if kind in ("sketch_sum", "sketch_max"):
            return value[0]
        return value

    def _child_state_from_raw(self, raw: Dict[str, Tensor]) -> Dict[str, Any]:
        """A child state from one tensor per state (the fault counters and
        the sketches wrapped around theirs)."""
        state: Dict[str, Any] = {}
        for name, kind in self._specs.items():
            v = raw[name]
            if kind == "faults":
                state[name] = FaultCounters(counts=v)
            elif kind in ("sketch_sum", "sketch_max"):
                state[name] = type(self.wrapped._defaults[name])(v)
            else:
                state[name] = v
        return state

    # ------------------------------------------------------------------
    # update: per-row deltas, segment-reduced into the rings
    # ------------------------------------------------------------------

    def _row_deltas(self, args: tuple, kwargs: Dict[str, Any], n: int) -> Dict[str, Tensor]:
        """``{state: (n, *shape) tensor}``: each row's contribution, the
        wrapped update run on a fresh state per row under ``vmap``."""
        child = self.wrapped

        def aligned(v: Any) -> bool:
            shape = getattr(v, "shape", None)
            return shape is not None and len(shape) >= 1 and shape[0] == n

        row_arg_idx = [i for i, a in enumerate(args) if aligned(a)]
        row_kw_keys = [k for k, v in kwargs.items() if aligned(v)]
        mapped = [args[i] for i in row_arg_idx] + [kwargs[k] for k in row_kw_keys]
        names = list(self._specs)
        # a fresh state per row, as a mapped input: the update's in-place
        # writes then land in batched tensors
        defaults = [self._leaf(name, child._defaults[name]) for name in names]
        fresh = [d.unsqueeze(0).repeat((n,) + (1,) * d.ndim) for d in defaults]

        def per_row(leaves: List[Tensor], _row: Tensor, *rows: Tensor) -> List[Tensor]:
            a = list(args)
            for i, v in zip(row_arg_idx, rows):
                a[i] = v.unsqueeze(0)
            kw = dict(kwargs)
            for k, v in zip(row_kw_keys, rows[len(row_arg_idx):]):
                kw[k] = v.unsqueeze(0)
            prev = child.__dict__["_state"]
            object.__setattr__(child, "_state", self._child_state_from_raw(dict(zip(names, leaves))))
            try:
                child._original_update(*a, **kw)
                out = child.__dict__["_state"]
                return [self._leaf(name, out[name]) for name in names]
            finally:
                object.__setattr__(child, "_state", prev)

        with value_checks_off():
            out = torch.func.vmap(per_row)(fresh, torch.arange(n, device=self.device), *mapped)
        return dict(zip(names, out))

    def update(self, *args: Any, slice_ids: Optional[Tensor] = None, valid: Optional[Tensor] = None, **kwargs: Any) -> None:
        if slice_ids is None:
            raise MetricsTPUUserError(
                f"SlicedMetric({type(self.wrapped).__name__}).update needs a `slice_ids` "
                "keyword argument: an int array with one slice id per batch row."
            )
        K = self.num_slices
        ids = torch.as_tensor(slice_ids, device=self.device).reshape(-1).to(torch.int32)
        n = int(ids.shape[0])
        if valid is None:
            vmask = torch.ones((n,), dtype=torch.bool, device=self.device)
        else:
            vmask = torch.as_tensor(valid, device=self.device).to(torch.bool).reshape(-1)
        # invalid rows to the discard (K + 1), ids out of range to the
        # quarantine (K), every other row to its slice
        in_range = (ids >= 0) & (ids < K)
        tgt = torch.where(~vmask, K + 1, torch.where(in_range, ids, K)).to(torch.int64)

        if valid is not None:
            kwargs = {**kwargs, "valid": valid}
        deltas = self._row_deltas(args, self.wrapped._filter_kwargs(**kwargs), n)

        for name, kind in self._specs.items():
            ring_name = f"{SLICE_STATE_PREFIX}{name}"
            ring = getattr(self, ring_name)
            leaf = deltas[name].to(ring.dtype)
            if kind in _SUM_KINDS:
                ring = ring.index_add(0, tgt, leaf)
            else:
                index = tgt.reshape((n,) + (1,) * (leaf.ndim - 1)).expand_as(leaf)
                ring = ring.scatter_reduce(0, index, leaf, "amax" if kind in ("max", "sketch_max") else "amin")
            setattr(self, ring_name, ring)
        rows_name = f"{SLICE_STATE_PREFIX}rows"
        rows = getattr(self, rows_name)
        setattr(self, rows_name, rows.index_add(0, tgt, torch.ones((n,), dtype=rows.dtype, device=rows.device)))

    # ------------------------------------------------------------------
    # compute: per-slice child states and the rollup
    # ------------------------------------------------------------------

    def _per_slice_raw(self) -> Dict[str, Tensor]:
        """Each state's ring over the slices, ``(K, ...)`` (quarantine and
        discard left out), a mean ring divided by each slice's rows."""
        K = self.num_slices
        rows = getattr(self, f"{SLICE_STATE_PREFIX}rows")[:K]
        raw: Dict[str, Tensor] = {}
        for name, kind in self._specs.items():
            ring = getattr(self, f"{SLICE_STATE_PREFIX}{name}")[:K]
            if kind == "mean":
                denom = torch.clamp_min(rows, 1).to(torch.float32)
                raw[name] = ring / denom.reshape((K,) + (1,) * (ring.ndim - 1))
            else:
                raw[name] = ring
        return raw

    def _rollup_raw(self) -> Dict[str, Tensor]:
        """The state of all slices together: sums add, means weigh by each
        slice's rows, max and min reduce. The quarantined rows are left out
        (their cohort is unknown): they are a count, not part of the
        rollup."""
        K = self.num_slices
        total = torch.clamp_min(getattr(self, f"{SLICE_STATE_PREFIX}rows")[:K].sum(), 1).to(torch.float32)
        raw: Dict[str, Tensor] = {}
        for name, kind in self._specs.items():
            ring = getattr(self, f"{SLICE_STATE_PREFIX}{name}")[:K]
            if kind in ("sum", "faults", "sketch_sum"):
                # in the ring's dtype, as jnp.sum keeps int32 (torch's sum would widen it)
                raw[name] = ring.sum(dim=0, dtype=ring.dtype)
            elif kind == "mean":
                raw[name] = ring.sum(dim=0) / total
            elif kind in ("max", "sketch_max"):
                raw[name] = ring.amax(dim=0)
            else:
                raw[name] = ring.amin(dim=0)
        return raw

    def _run_raw(self, raw: Dict[str, Tensor]) -> Any:
        return self._run_child_compute(self._child_state_from_raw(raw))

    def _per_slice_values(self, raw: Dict[str, Tensor]) -> Any:
        """The wrapped compute of every slice at once, under ``vmap``."""
        names = list(raw)

        def run(*leaves: Tensor) -> Any:
            return self._run_raw(dict(zip(names, leaves)))

        with value_checks_off():
            return torch.func.vmap(run)(*(raw[n] for n in names))

    def compute(self) -> SlicedValue:
        return SlicedValue(
            per_slice=self._per_slice_values(self._per_slice_raw()),
            global_value=self._run_raw(self._rollup_raw()),
            quarantined_rows=getattr(self, f"{SLICE_STATE_PREFIX}rows")[self.num_slices],
        )

    # ------------------------------------------------------------------
    # host-side counts and the bounded scrape
    # ------------------------------------------------------------------

    @property
    def slice_rows(self) -> np.ndarray:
        """Rows folded into each slice (read back)."""
        return getattr(self, f"{SLICE_STATE_PREFIX}rows")[: self.num_slices].cpu().numpy()

    @property
    def quarantined_rows(self) -> int:
        """Valid rows whose slice id lay outside ``[0, num_slices)`` (read
        back)."""
        return int(getattr(self, f"{SLICE_STATE_PREFIX}rows")[self.num_slices])

    @property
    def discarded_rows(self) -> int:
        """Rows masked invalid, pad rows included (read back)."""
        return int(getattr(self, f"{SLICE_STATE_PREFIX}rows")[self.num_slices + 1])

    def _aggregated_fault_counts(self) -> Optional[Tensor]:
        ring = self._state.get(f"{SLICE_STATE_PREFIX}_faults")
        # every row's evidence, quarantine and discard included
        return None if ring is None else ring.sum(dim=0)

    def scrape_slices(self, max_labels: Optional[int] = None) -> Dict[str, Any]:
        """The top ``max_labels`` slices by rows, each with its scalar
        values, and the tail as one ``other`` bucket (default cap
        :func:`slices_max_labels`). Reads back."""
        cap = slices_max_labels() if max_labels is None else int(max_labels)
        if cap < 1:
            raise ValueError(f"`max_labels` must be >= 1, got {max_labels}")
        K = self.num_slices
        rows = self.slice_rows
        out: Dict[str, Any] = {
            "num_slices": K,
            "max_labels": cap,
            "top": [],
            "other": {"slices": 0, "rows": 0},
            "quarantined_rows": self.quarantined_rows,
            "discarded_rows": self.discarded_rows,
        }
        if int(rows.sum()) == 0:
            return out
        leaves = []
        for name, leaf in _value_leaves(self.compute().per_slice):
            arr = leaf.detach().cpu().numpy() if isinstance(leaf, Tensor) else np.asarray(leaf)
            if arr.shape == (K,):
                leaves.append((name, arr))
        order = np.argsort(-rows, kind="stable")
        for k in order[:cap]:
            if rows[k] > 0:
                out["top"].append({"slice": int(k), "rows": int(rows[k]), "values": {name: float(arr[k]) for name, arr in leaves}})
        tail = [int(k) for k in order[cap:] if rows[k] > 0]
        out["other"] = {"slices": len(tail), "rows": int(sum(int(rows[k]) for k in tail))}
        return out
