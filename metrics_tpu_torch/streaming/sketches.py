"""Mergeable streaming sketches: quantiles, frequencies, distinct counts
(counterpart of ``metrics_tpu/streaming/sketches.py``).

Each sketch keeps a fixed-size state, a NamedTuple of tensors that a metric
registers with ``add_state`` (the runtime recognises it by the class marker
``is_sketch_state``), with an associative and commutative ``sketch_merge``:

- :class:`QuantileSketchState`: ``(L, k)`` compactor levels (``ops/compactor.py``,
  kernel K3 on the card); rank error at most ``eps_bound * n``;
- :class:`CountMinState`: ``(depth, width)`` counters, merged by sum;
  estimates never under-count, and over-count by at most ``2n / width`` with
  probability ``1 - 2**-depth``;
- :class:`HllState`: ``2**precision`` HyperLogLog registers, merged by max;
  relative error about ``1.04 / sqrt(2**precision)``.

The states hold the JAX package's values. Where JAX keeps uint32 (the
CountMin counters, the hash lanes) the port keeps int64 of the same value:
the counters do not wrap at ``2**32``, and the hashes are computed in int64
with every product kept below ``2**63``. Hashing sees a float by its bits,
with ``-0.0`` and denormals taken as ``+0.0``, as the JAX package's
``x + 0.0`` gives them on the CPU and the TPU, which flush denormals.

A sketch metric takes ``on_invalid`` like any metric: its update leaves
non-finite rows out by itself, and the fault channel counts them (as
``nonfinite_preds`` and ``dropped_rows``). In a multi-process sync
(``parallel/sync.py::fused_sync``) the CountMin counters join the sum
bucket, the HyperLogLog registers the max bucket, and the quantile
sketches travel packed (:meth:`QuantileSketchState.pack`) and fold with
``sketch_merge`` in rank order.
"""
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric, resolve_device
from metrics_tpu_torch.ops.binning import halving_level, precompact_binned
from metrics_tpu_torch.ops.compactor import (
    fold_cascade,
    merge_cascade,
    weighted_cdf,
    weighted_quantiles,
    weighted_rank,
)
from metrics_tpu_torch.utilities.data import _squeeze_if_scalar
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor
Device = Union[str, torch.device, None]

__all__ = [
    "QuantileSketchState",
    "CountMinState",
    "HllState",
    "QuantileSketch",
    "CountMinSketch",
    "HyperLogLog",
]

_U32 = 0xFFFFFFFF
_INF = float("inf")


def is_sketch_state(value: Any) -> bool:
    """Whether ``value`` is a sketch state, by its class marker."""
    return getattr(type(value), "is_sketch_state", False)


def _hash_keys(values: Tensor) -> Tensor:
    """uint32 hash keys as int64: a float by its float32 bits (``-0.0`` and
    denormals as ``+0.0``, so equal values hash equally), an integer
    truncated to its low 32 bits."""
    x = values.reshape(-1)
    if x.is_floating_point():
        bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
        return torch.where((bits & 0x7F800000) == 0, 0, bits)
    return x.to(torch.int64) & _U32


def _mul32(x: Tensor, y: Union[Tensor, int]) -> Tensor:
    """``x * y mod 2**32`` for values in ``[0, 2**32)``, in 16-bit halves so
    that no int64 product overflows."""
    x_lo, x_hi = x & 0xFFFF, x >> 16
    y_lo, y_hi = y & 0xFFFF, y >> 16
    return (x_lo * y_lo + (((x_hi * y_lo + x_lo * y_hi) & 0xFFFF) << 16)) & _U32


def _fmix32(h: Tensor) -> Tensor:
    """murmur3 finalizer over uint32 lanes held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _as_state_tensor(value: Any, like: Tensor, what: str) -> Tensor:
    """``value`` (tensor, numpy or anything ``np.asarray`` takes) in
    ``like``'s dtype on ``like``'s device."""
    if isinstance(value, Tensor):
        return value.detach().to(device=like.device, dtype=like.dtype).clone()
    arr = np.asarray(value)
    if arr.dtype == object or not (np.issubdtype(arr.dtype, np.number) or arr.dtype == bool):
        raise ValueError(f"{what} must be a numeric array, got {type(value).__name__}")
    return torch.from_numpy(np.array(arr)).to(device=like.device, dtype=like.dtype)


def _primitives_dict(prim: Any, cls: type) -> Any:
    """A state of ``cls`` (the port's or a NamedTuple of the JAX package's)
    as its mapping of fields; anything else unchanged."""
    if isinstance(prim, cls):
        return prim.to_primitives()
    if hasattr(prim, "_asdict"):
        return dict(prim._asdict())
    return prim


# --------------------------------------------------------------------------
# QuantileSketch: compactor levels (ops/compactor.py)
# --------------------------------------------------------------------------


class QuantileSketchState(NamedTuple):
    """Compactor quantile sketch: ``(L, k)`` ascending level buffers (an item
    at level ``l`` stands for ``2**l`` rows; ``+inf`` past each level's
    ``counts`` prefix) and the exact count of inserted rows."""

    items: Tensor  # (L, k) float32
    counts: Tensor  # (L,) int32
    n_seen: Tensor  # () int32

    is_sketch_state = True
    # the merge is compaction, not elementwise
    elementwise_reduction = None

    @classmethod
    def create(
        cls,
        eps: float = 0.01,
        max_items: int = 1 << 30,
        k: Optional[int] = None,
        levels: Optional[int] = None,
        device: Device = None,
    ) -> "QuantileSketchState":
        """An empty sketch sized for rank error ``eps`` over ``max_items``
        rows. ``device=None`` means CUDA, as for a metric."""
        if not (0 < eps < 1):
            raise ValueError(f"`eps` must be in (0, 1), got {eps}")
        if k is None:
            # worst-case rank error ~ 2 * (L + 1) * n / k (ops/compactor.py)
            guess_levels = max(4, int(math.ceil(math.log2(max(max_items, 2)))) + 2)
            k = int(math.ceil(2.0 * (guess_levels + 1) / eps))
        k = max(8, k + (k % 2))  # even, so pair compaction has no odd tail
        if levels is None:
            levels = max(4, int(math.ceil(math.log2(max(max_items / k, 2.0)))) + 2)
        dev = resolve_device(device)
        return cls(
            items=torch.full((levels, k), _INF, dtype=torch.float32, device=dev),
            counts=torch.zeros((levels,), dtype=torch.int32, device=dev),
            n_seen=torch.zeros((), dtype=torch.int32, device=dev),
        )

    # -- streaming ------------------------------------------------------

    def insert(self, values: Tensor, valid: Optional[Tensor] = None) -> "QuantileSketchState":
        """Fold one batch in; non-finite rows are always left out. Reads
        nothing back to the host."""
        x = torch.as_tensor(values, device=self.items.device).to(torch.float32).reshape(-1)
        if valid is None:
            v = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        else:
            v = torch.as_tensor(valid, device=x.device).to(torch.bool).reshape(-1)
        L, k = self.items.shape
        level = halving_level(x.shape[0], k)
        if level >= L:
            # one batch would promote past the top level (max_items was set
            # below a batch's size): split it into the fewest chunks that
            # land within the cascade, so that no row is lost
            v = torch.broadcast_to(v, x.shape)
            chunks = 1 << (level - (L - 1))
            step = -(-x.shape[0] // chunks)
            state = self
            for i in range(0, x.shape[0], step):
                state = state.insert(x[i : i + step], v[i : i + step])
            return state
        inc, inc_count, level = precompact_binned(x, v, k)
        items, counts = fold_cascade(self.items, self.counts, inc, inc_count, level)
        n = torch.sum(v & torch.isfinite(x), dtype=torch.int32)
        return QuantileSketchState(items=items, counts=counts, n_seen=self.n_seen + n)

    def sketch_merge(self, other: "QuantileSketchState") -> "QuantileSketchState":
        """Union of two sketches, bitwise commutative: one merge cascade
        (``ops/compactor.py::merge_cascade``, one launch of K3 on the card)."""
        if self.items.shape != other.items.shape:
            raise ValueError(
                f"cannot merge QuantileSketchState of shape {tuple(self.items.shape)} with "
                f"{tuple(other.items.shape)}; construct both with the same eps/k/levels"
            )
        items, counts = merge_cascade(self.items, self.counts, other.items, other.counts)
        return QuantileSketchState(items=items, counts=counts, n_seen=self.n_seen + other.n_seen)

    # -- queries --------------------------------------------------------

    def quantile(self, qs: Any) -> Tensor:
        qs = torch.atleast_1d(torch.as_tensor(qs, dtype=torch.float32, device=self.items.device))
        return weighted_quantiles(self.items, self.counts, qs)

    def rank(self, v: Any) -> Tensor:
        """Estimated rows ``<= v`` (error ``<= eps_bound * n``)."""
        return weighted_rank(self.items, self.counts, v)

    def cdf(self, points: Any) -> Tensor:
        """Estimated CDF at many probe points in one pass: the fraction of
        inserted rows ``<= points[i]``, each off by at most ``eps_bound``.
        An empty sketch answers NaN everywhere."""
        return weighted_cdf(self.items, self.counts, points)

    @property
    def eps_bound(self) -> float:
        """Worst-case rank-error fraction of this geometry."""
        L, k = self.items.shape
        return 2.0 * (L + 1) / k

    # -- serialization / transport --------------------------------------

    def to_primitives(self) -> Dict[str, Tensor]:
        return {"items": self.items.clone(), "counts": self.counts.clone(), "n_seen": self.n_seen.clone()}

    @classmethod
    def from_primitives(cls, prim: Any, like: "QuantileSketchState") -> "QuantileSketchState":
        """Rebuild from ``to_primitives()`` (this package's or the JAX
        package's) or a state of either package, on ``like``'s device,
        refusing another geometry."""
        prim = _primitives_dict(prim, cls)
        if not isinstance(prim, dict) or not {"items", "counts"} <= set(prim):
            raise ValueError(
                "QuantileSketchState loads from an {'items', 'counts', 'n_seen'} mapping, "
                f"got {type(prim).__name__}"
            )
        items = _as_state_tensor(prim["items"], like.items, "QuantileSketchState items")
        if tuple(items.shape) != tuple(like.items.shape):
            raise ValueError(
                f"QuantileSketchState items shape {tuple(items.shape)} != expected "
                f"{tuple(like.items.shape)} (eps/k/levels config mismatch?)"
            )
        counts = _as_state_tensor(prim["counts"], like.counts, "QuantileSketchState counts").reshape(-1)
        if counts.shape[0] != like.counts.shape[0]:
            raise ValueError(
                f"QuantileSketchState counts length {counts.shape[0]} != expected {like.counts.shape[0]}"
            )
        n_seen = _as_state_tensor(prim.get("n_seen", 0), like.n_seen, "QuantileSketchState n_seen").reshape(())
        return cls(items=items, counts=counts, n_seen=n_seen)

    def pack(self) -> Tensor:
        """One flat float32 vector: the items, the counts (``<= k < 2**24``,
        exact in float32), and ``n_seen`` as two 12-bit-split lanes
        (``hi * 4096 + lo``), exact for the whole int32 range."""
        n = self.n_seen.to(torch.int32)
        return torch.cat(
            [
                self.items.reshape(-1),
                self.counts.to(torch.float32),
                (n // 4096).to(torch.float32).reshape(1),
                (n % 4096).to(torch.float32).reshape(1),
            ]
        )

    @classmethod
    def unpack_like(cls, flat: Tensor, like: "QuantileSketchState") -> "QuantileSketchState":
        L, k = like.items.shape
        n = flat[L * k + L].to(torch.int32) * 4096 + flat[L * k + L + 1].to(torch.int32)
        return cls(
            items=flat[: L * k].reshape(L, k),
            counts=flat[L * k : L * k + L].to(torch.int32),
            n_seen=n,
        )

    @property
    def packed_size(self) -> int:
        L, k = self.items.shape
        return L * k + L + 2


# --------------------------------------------------------------------------
# CountMinSketch: frequency estimates, merged by sum
# --------------------------------------------------------------------------

_CM_SEED = 0x9E3779B9


def _cm_hash_params(depth: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row multiply-shift constants, a function of ``depth`` alone, so
    sketches of one shape are merge-compatible."""
    rng = np.random.default_rng(_CM_SEED)
    a = (rng.integers(0, 1 << 32, depth, dtype=np.uint64).astype(np.uint32)) | np.uint32(1)
    b = rng.integers(0, 1 << 32, depth, dtype=np.uint64).astype(np.uint32)
    return a, b


@functools.lru_cache(maxsize=64)
def _cm_hash_tensors(depth: int, device: torch.device) -> Tuple[Tensor, Tensor]:
    """:func:`_cm_hash_params` as ``(depth, 1)`` int64 tensors on ``device``,
    made once per ``(depth, device)``."""
    a, b = _cm_hash_params(depth)
    return (
        torch.from_numpy(a.astype(np.int64)).to(device).reshape(depth, 1),
        torch.from_numpy(b.astype(np.int64)).to(device).reshape(depth, 1),
    )


class CountMinState(NamedTuple):
    """Count-min frequency sketch: ``(depth, width)`` counters (int64 here,
    uint32 in the JAX package), merged by elementwise sum."""

    counts: Tensor  # (depth, width) int64

    is_sketch_state = True
    elementwise_reduction = "sum"

    @classmethod
    def create(cls, depth: int = 4, width: int = 2048, device: Device = None) -> "CountMinState":
        if width & (width - 1) or width < 2:
            raise ValueError(f"`width` must be a power of two >= 2, got {width}")
        if depth < 1:
            raise ValueError(f"`depth` must be >= 1, got {depth}")
        return cls(counts=torch.zeros((depth, width), dtype=torch.int64, device=resolve_device(device)))

    def _indices(self, values: Tensor) -> Tensor:
        depth, width = self.counts.shape
        a, b = _cm_hash_tensors(depth, self.counts.device)
        keys = _hash_keys(torch.as_tensor(values, device=self.counts.device))
        h = _fmix32((_mul32(keys[None, :], a) + b) & _U32)
        return h & (width - 1)  # (depth, n)

    def insert(self, values: Tensor, valid: Optional[Tensor] = None) -> "CountMinState":
        idx = self._indices(values)
        depth, width = self.counts.shape
        inc = torch.ones(idx.shape[1], dtype=torch.int64, device=idx.device)
        if valid is not None:
            inc = torch.as_tensor(valid, device=idx.device).to(torch.bool).reshape(-1).to(torch.int64) * inc
        flat = idx + torch.arange(depth, device=idx.device)[:, None] * width
        counts = self.counts.reshape(-1).index_add(0, flat.reshape(-1), torch.broadcast_to(inc, idx.shape).reshape(-1))
        return CountMinState(counts=counts.reshape(depth, width))

    def query(self, values: Tensor) -> Tensor:
        """Estimated occurrence counts (never under-counts)."""
        return torch.amin(self.counts.gather(1, self._indices(values)), dim=0)

    def sketch_merge(self, other: "CountMinState") -> "CountMinState":
        if self.counts.shape != other.counts.shape:
            raise ValueError(
                f"cannot merge CountMinState of shape {tuple(self.counts.shape)} with "
                f"{tuple(other.counts.shape)}; construct both with the same depth/width"
            )
        return CountMinState(counts=self.counts + other.counts)

    def to_primitives(self) -> Dict[str, Tensor]:
        return {"counts": self.counts.clone()}

    @classmethod
    def from_primitives(cls, prim: Any, like: "CountMinState") -> "CountMinState":
        prim = _primitives_dict(prim, cls)
        if not isinstance(prim, dict) or "counts" not in prim:
            raise ValueError(f"CountMinState loads from a {{'counts'}} mapping, got {type(prim).__name__}")
        counts = _as_state_tensor(prim["counts"], like.counts, "CountMinState counts")
        if tuple(counts.shape) != tuple(like.counts.shape):
            raise ValueError(
                f"CountMinState counts shape {tuple(counts.shape)} != expected "
                f"{tuple(like.counts.shape)} (depth/width config mismatch?)"
            )
        return cls(counts=counts)


# --------------------------------------------------------------------------
# HyperLogLog: distinct counts, merged by max
# --------------------------------------------------------------------------


def _clz32(w: Tensor) -> Tensor:
    """Leading zeros of 32-bit values ``w >= 1`` (int64), exactly, from the
    float64 exponent: ``w = m * 2**e`` with ``m`` in ``[0.5, 1)``."""
    _, e = torch.frexp(w.to(torch.float64))
    return 32 - e.to(torch.int64)


class HllState(NamedTuple):
    """HyperLogLog registers: ``(2**precision,)`` int32, merged by
    elementwise max."""

    registers: Tensor  # (m,) int32

    is_sketch_state = True
    elementwise_reduction = "max"

    @classmethod
    def create(cls, precision: int = 11, device: Device = None) -> "HllState":
        if not (4 <= precision <= 18):
            raise ValueError(f"`precision` must be in [4, 18], got {precision}")
        return cls(registers=torch.zeros((1 << precision,), dtype=torch.int32, device=resolve_device(device)))

    @property
    def precision(self) -> int:
        return int(self.registers.shape[0]).bit_length() - 1

    def insert(self, values: Tensor, valid: Optional[Tensor] = None) -> "HllState":
        p = self.precision
        h = _fmix32(_hash_keys(torch.as_tensor(values, device=self.registers.device)))
        idx = h >> (32 - p)
        w = (h << p) & _U32
        rho = torch.where(w == 0, 32 - p + 1, _clz32(w) + 1)
        if valid is not None:
            v = torch.as_tensor(valid, device=idx.device).to(torch.bool).reshape(-1)
            rho = torch.where(v, rho, 0)  # max with 0 changes nothing
            idx = torch.where(v, idx, 0)
        return HllState(registers=self.registers.scatter_reduce(0, idx, rho.to(torch.int32), reduce="amax"))

    def estimate(self) -> Tensor:
        """Distinct-count estimate with the standard small- and large-range
        corrections (32-bit hash), in float32."""
        m = self.registers.shape[0]
        dev = self.registers.device
        alpha = 0.7213 / (1.0 + 1.079 / m) if m >= 128 else {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1.0 + 1.079 / m))

        def f32(x: float) -> Tensor:
            # a tensor divided by a tensor: a Python number as the divisor or
            # dividend may be applied as a reciprocal, which rounds otherwise
            return torch.full((), x, dtype=torch.float32, device=dev)

        reg = self.registers.to(torch.float32)
        raw = f32(alpha * m * m) / torch.sum(torch.exp2(-reg))
        zeros = torch.sum(self.registers == 0).to(torch.float32)
        linear = m * torch.log(f32(m) / torch.clamp(zeros, min=1.0))
        est = torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
        two32 = 2.0**32
        large = float(np.float32(two32) / np.float32(30.0))
        return torch.where(est > large, -two32 * torch.log1p(-est / two32), est)

    def sketch_merge(self, other: "HllState") -> "HllState":
        if self.registers.shape != other.registers.shape:
            raise ValueError(
                f"cannot merge HllState with {self.registers.shape[0]} registers and "
                f"{other.registers.shape[0]}; construct both with the same precision"
            )
        return HllState(registers=torch.maximum(self.registers, other.registers))

    def to_primitives(self) -> Dict[str, Tensor]:
        return {"registers": self.registers.clone()}

    @classmethod
    def from_primitives(cls, prim: Any, like: "HllState") -> "HllState":
        prim = _primitives_dict(prim, cls)
        if not isinstance(prim, dict) or "registers" not in prim:
            raise ValueError(f"HllState loads from a {{'registers'}} mapping, got {type(prim).__name__}")
        registers = _as_state_tensor(prim["registers"], like.registers, "HllState registers").reshape(-1)
        if tuple(registers.shape) != tuple(like.registers.shape):
            raise ValueError(
                f"HllState registers shape {tuple(registers.shape)} != expected "
                f"{tuple(like.registers.shape)} (precision config mismatch?)"
            )
        return cls(registers=registers)


# --------------------------------------------------------------------------
# Metric shells
# --------------------------------------------------------------------------


class _SketchMetric(Metric):
    """Shared shell: one sketch state; non-finite rows are left out."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    # the update itself leaves invalid rows out, so the guard's drop policy
    # only counts them
    _guard_handles_drop = True
    nan_strategy = "ignore"  # read by the guard; a sketch always masks

    @staticmethod
    def _valid_rows(values: Tensor) -> Tensor:
        x = values.reshape(-1)
        if x.is_floating_point():
            return torch.isfinite(x)
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)


class QuantileSketch(_SketchMetric):
    """Streaming quantiles over a value stream at a fixed state size.

    ``compute()`` returns the configured ``quantiles`` of everything seen
    since reset, with rank error at most ``eps_bound * n``; a ``forward``
    merges the batch's sketch in with ``sketch_merge``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import QuantileSketch
        >>> m = QuantileSketch(eps=0.05, max_items=4096, quantiles=(0.5,), device="cpu")
        >>> m.update(torch.arange(1000.0))
        >>> bool(abs(float(m.compute()) - 500.0) <= 0.05 * 1000)
        True
    """

    def __init__(
        self,
        eps: float = 0.01,
        max_items: int = 1 << 30,
        quantiles: Sequence[float] = (0.5, 0.9, 0.99),
        k: Optional[int] = None,
        levels: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.eps = float(eps)
        self.quantiles = tuple(float(q) for q in quantiles)
        if not self.quantiles or not all(0.0 <= q <= 1.0 for q in self.quantiles):
            raise ValueError(f"`quantiles` must be fractions in [0, 1], got {quantiles}")
        self.add_state(
            "sketch",
            default=QuantileSketchState.create(eps=eps, max_items=max_items, k=k, levels=levels, device=self.device),
            dist_reduce_fx="cat",  # documentary: the runtime merges sketch states with sketch_merge
        )

    def update(self, values: Tensor) -> None:
        x = values.to(torch.float32).reshape(-1)
        self.sketch = self.sketch.insert(x, self._valid_rows(x))

    def compute(self) -> Tensor:
        return self.sketch.quantile(self.quantiles)

    def _check_cat_overflow(self) -> None:
        """Saturation is never silent: past ``k * (2**L - 1)`` rows the top
        level clamps and the eps contract no longer holds, which happens
        only when ``max_items`` was set below the stream's length."""
        if self.on_overflow == "ignore":
            return
        st = self._state["sketch"]
        n = int(st.n_seen)
        L, k = st.items.shape
        capacity = k * ((1 << L) - 1)  # the total row weight the levels hold
        if n <= capacity:
            return
        msg = (
            f"{type(self).__name__}: the stream ({n} rows) exceeded this sketch's "
            f"~{capacity}-row design capacity (max_items was configured too small); the top "
            "compactor level has saturated and rank error can exceed the eps contract. "
            "Construct with a larger `max_items`, or pass `on_overflow='ignore'` to silence "
            "this."
        )
        if self.on_overflow == "error":
            raise MetricsTPUUserError(msg)
        if not self.__dict__.get("_saturation_warned"):
            object.__setattr__(self, "_saturation_warned", True)
            rank_zero_warn(msg, UserWarning)

    def quantile(self, qs: Any) -> Tensor:
        """Ad-hoc quantile query against the current state."""
        return _squeeze_if_scalar(self.sketch.quantile(qs))

    def cdf(self, points: Any) -> Tensor:
        """Ad-hoc CDF query against the current state
        (see :meth:`QuantileSketchState.cdf`)."""
        return self.sketch.cdf(points)


class CountMinSketch(_SketchMetric):
    """Streaming per-item frequency estimates (count-min).

    ``update(values)`` hashes each row into ``depth`` counter rows;
    :meth:`query` returns estimates that never under-count. ``compute()``
    returns the counter matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CountMinSketch
        >>> m = CountMinSketch(depth=4, width=256, device="cpu")
        >>> m.update(torch.tensor([7, 7, 7, 3]))
        >>> int(m.query(torch.tensor([7]))[0])
        3
    """

    def __init__(self, depth: int = 4, width: int = 2048, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.depth = int(depth)
        self.width = int(width)
        self.add_state("sketch", default=CountMinState.create(depth, width, device=self.device), dist_reduce_fx="sum")

    def update(self, values: Tensor) -> None:
        self.sketch = self.sketch.insert(values, self._valid_rows(values))

    def compute(self) -> Tensor:
        return self.sketch.counts

    def query(self, values: Tensor) -> Tensor:
        return self.sketch.query(values)


class HyperLogLog(_SketchMetric):
    """Streaming distinct-count estimate (HyperLogLog).

    ``compute()`` estimates the number of distinct values seen since reset
    with relative error about ``1.04 / sqrt(2**precision)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HyperLogLog
        >>> m = HyperLogLog(precision=11, device="cpu")
        >>> m.update(torch.arange(5000) % 1000)
        >>> bool(abs(float(m.compute()) - 1000) / 1000 < 0.1)
        True
    """

    def __init__(self, precision: int = 11, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.precision = int(precision)
        self.add_state("sketch", default=HllState.create(precision, device=self.device), dist_reduce_fx="max")

    def update(self, values: Tensor) -> None:
        self.sketch = self.sketch.insert(values, self._valid_rows(values))

    def compute(self) -> Tensor:
        return self.sketch.estimate()
