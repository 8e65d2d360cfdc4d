"""Fixed-shape compactor levels of the streaming quantile sketch
(counterpart of ``metrics_tpu/ops/compactor.py``).

A sketch keeps ``L`` levels of ``k`` ascending items each, ``+inf`` past
each level's valid ``count``; an item at level ``l`` stands for ``2**l``
rows. Folding a run of items into a level merges the two; when the merge
holds more than ``k`` values the whole buffer compacts: of each adjacent
pair the item at ``2j + (j & 1)`` is promoted to the next level, and an odd
leftover stays. The kept side alternates, so the fold is a function of the
sorted values alone and merging two sketches is bitwise commutative.

Kernel K3 (``csrc/compactor_fold.cu``) has two wrappers here:

- :func:`fold_cascade` and :func:`merge_cascade` run a whole sketch update
  (a run folded into its level, the promoted run up the levels, the top
  level absorbing) or a whole sketch merge in ONE launch of the cascade
  kernel, which reads and writes every count on the device, so neither
  reads anything back to the host. On a CPU tensor they run
  :func:`fold_cascade_plain` and :func:`merge_cascade_plain`, the per-level
  composition of :func:`compactor_fold_plain`, which is also what the
  kernel is held against on the card.
- :func:`compactor_fold` (and :func:`fold_level`) fold one level, the
  counterpart of the JAX package's single fold: on a CUDA tensor one launch
  of the fold kernel; on a CPU tensor :func:`compactor_fold_plain`, a
  ``torch.sort`` of the concatenation followed by
  :func:`_compactor_fold_select`, the port of the JAX package's post-sort
  stage.

On a CUDA tensor every wrapper launches its kernel or raises; no switch
sends a CUDA tensor to a plain version.

The JAX package skips the levels that the promotion does not reach with a
``lax.cond`` on the incoming count. The cascade kernel does the same on the
device: once the carry is empty it copies the levels above through.

Rank error: a compaction at level ``l`` moves any rank by at most ``2**l``,
so over ``n`` rows the error stays below about ``2 (L + 1) n / k``
(``QuantileSketchState.eps_bound``).
"""
import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops.bucketed_rank import ascending_order

Tensor = torch.Tensor

SOURCE = "compactor_fold.cu"

_INF = float("inf")
_INT32_MAX = (1 << 31) - 1

# launches since the last reset_launch_count(), read by chip_smoke.py: of
# the cascade kernel (the sketch paths' K3) and of the single-fold kernel
launch_count = 0
fold_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, fold_launch_count
    launch_count = 0
    fold_launch_count = 0


def masked_ascending(x: Tensor, count: Tensor) -> Tensor:
    """Positions ``>= count`` forced to ``+inf`` (the level invariant)."""
    return torch.where(torch.arange(x.shape[0], device=x.device) < count, x, _INF)


def _compactor_fold_select(combined: Tensor, c: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Post-sort compact/select stage: ``combined`` is the ascending
    ``(k + M,)`` concatenation with ``c`` valid values in its prefix."""
    dev = combined.device
    overflow = c > k
    keep_items = combined[:k]
    pairs = c // 2
    p_len = combined.shape[0] // 2
    j = torch.arange(p_len, device=dev)
    picked = combined[2 * j + (j & 1)]  # one per adjacent pair, alternating
    promoted = torch.where(j < pairs, picked, _INF)
    leftover_count = c - 2 * pairs  # 0 or 1
    # a gather, not combined[tensor]: indexing by a 0-d tensor reads it back
    # to the host. The index is clamped, as a JAX gather clamps it.
    at = torch.clamp(2 * pairs, max=combined.shape[0] - 1).to(torch.int64).reshape(1)
    leftover = torch.where(torch.arange(k, device=dev) < leftover_count, combined.gather(0, at), _INF)
    new_items = torch.where(overflow, leftover, keep_items)
    new_count = torch.where(overflow, leftover_count, c)
    promoted = torch.where(overflow, promoted, _INF)
    promoted_count = torch.where(overflow, pairs, 0)
    return new_items, new_count.to(torch.int32), promoted, promoted_count.to(torch.int32)


def compactor_fold_plain(
    a: Tensor, a_count: Tensor, b: Tensor, b_count: Tensor, k: int
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The plain version of K3: sort the concatenation, then select."""
    combined = torch.sort(torch.cat([a, b])).values
    return _compactor_fold_select(combined, a_count + b_count, k)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.compactor_fold_launch.argtypes = [p, i, p, i, p, p, i, p, p, p, p, p]
    lib.compactor_fold_launch.restype = i
    lib.compactor_cascade_scratch_floats.argtypes = [i, i, i]
    lib.compactor_cascade_scratch_floats.restype = ctypes.c_longlong
    lib.compactor_cascade_launch.argtypes = [p, p, i, i, p, i, p, i, p, p, p, p, p, p]
    lib.compactor_cascade_launch.restype = i
    return lib


def _compactor_fold_cuda(
    a: Tensor, a_count: Tensor, b: Tensor, b_count: Tensor, k: int
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Launch the single-fold kernel on PyTorch's current stream."""
    na, nb = a.shape[0], b.shape[0]
    a, b = a.contiguous(), b.contiguous()
    a_count = a_count.to(torch.int32).contiguous()
    b_count = b_count.to(torch.int32).contiguous()
    items = torch.empty((k,), dtype=torch.float32, device=a.device)
    promoted = torch.empty(((na + nb) // 2,), dtype=torch.float32, device=a.device)
    count = torch.empty((), dtype=torch.int32, device=a.device)
    pcount = torch.empty((), dtype=torch.int32, device=a.device)
    fn = _library().compactor_fold_launch
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(
        a.data_ptr(), na, b.data_ptr(), nb, a_count.data_ptr(), b_count.data_ptr(), k,
        items.data_ptr(), count.data_ptr(), promoted.data_ptr(), pcount.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"compactor_fold kernel launch failed with cudaError {err}")
    _build.count_launch(__name__, "fold_launch_count")
    return items, count, promoted, pcount


def compactor_fold(
    a: Tensor, a_count: Tensor, b: Tensor, b_count: Tensor, k: int
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Merge two ascending runs and fold the result into a level of ``k``.

    Args:
        a: ``(na,)`` float32, ascending, ``+inf`` past ``a_count`` values.
        a_count: 0-d integer tensor on ``a``'s device.
        b: ``(nb,)`` float32 in the same form, ``+inf`` past ``b_count``.
        b_count: 0-d integer tensor.
        k: the level's size, at most ``na + nb``.

    Returns:
        ``(items (k,), count, promoted ((na + nb) // 2,), promoted_count)``,
        the counts 0-d int32 tensors on the same device.
    """
    if a.ndim != 1 or b.ndim != 1 or a_count.numel() != 1 or b_count.numel() != 1:
        raise ValueError(
            f"compactor_fold expects two 1-D runs and two counts; got {tuple(a.shape)}, {tuple(b.shape)}, "
            f"counts of {a_count.numel()} and {b_count.numel()} elements"
        )
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"compactor_fold runs over float32, got {a.dtype} and {b.dtype}")
    if not (a.device == b.device == a_count.device == b_count.device):
        raise ValueError(
            f"compactor_fold's inputs must be on one device, got {a.device}, {b.device}, "
            f"{a_count.device} and {b_count.device}"
        )
    if not 1 <= k <= a.shape[0] + b.shape[0] or k + (a.shape[0] + b.shape[0]) // 2 > _INT32_MAX:
        raise ValueError(f"compactor_fold needs 1 <= k <= na + nb < 2^31, got k={k}, na={a.shape[0]}, nb={b.shape[0]}")
    if a.device.type == "cpu":
        return compactor_fold_plain(a, a_count.reshape(()), b, b_count.reshape(()), k)
    if a.device.type == "cuda":
        return _compactor_fold_cuda(a, a_count, b, b_count, k)
    raise ValueError(f"compactor_fold runs on CPU or CUDA tensors, got device {a.device}")


def fold_level(items: Tensor, count: Tensor, inc: Tensor, inc_count: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fold ``inc`` (same level weight) into one level buffer.

    ``items`` is ``(k,)`` ascending with ``count`` valid; ``inc`` is
    ``(M,)`` in the same form. Returns ``(new_items (k,), new_count,
    promoted ((k + M) // 2,), promoted_count)``: within ``k`` the level
    absorbs everything; past it the buffer compacts and at most one
    leftover stays."""
    return compactor_fold(items, count, inc, inc_count, items.shape[0])


def _absorb_top(items: Tensor, count: Tensor, inc: Tensor, inc_count: Tensor) -> Tuple[Tensor, Tensor]:
    """The top level never promotes: it absorbs and saturates at ``k`` items,
    which ``QuantileSketchState.create`` makes unreachable by sizing ``L``."""
    k = items.shape[0]
    combined = torch.sort(torch.cat([items, inc])).values
    c = torch.clamp(count + inc_count, max=k)
    return masked_ascending(combined[:k], c), c


def fold_cascade_plain(
    items: Tensor, counts: Tensor, inc: Tensor, inc_count: Tensor, start_level: int, fold: Callable = compactor_fold_plain
) -> Tuple[Tensor, Tensor]:
    """The plain version of an insert cascade: ``fold`` (by default
    :func:`compactor_fold_plain`) at every level from ``start_level`` up,
    then the top level's absorb. With ``fold=compactor_fold`` on CUDA
    tensors it is the per-level design the cascade kernel replaced."""
    L, k = items.shape
    rows = [items[lvl] for lvl in range(min(start_level, L))]
    cnts = [counts[lvl] for lvl in range(min(start_level, L))]
    for lvl in range(start_level, L):
        if lvl == L - 1:
            row, c = _absorb_top(items[lvl], counts[lvl], inc, inc_count)
        else:
            row, c, inc, inc_count = fold(items[lvl], counts[lvl], inc, inc_count, k)
        rows.append(row)
        cnts.append(c)
    return torch.stack(rows), torch.stack(cnts).to(torch.int32)


def merge_cascade_plain(
    items: Tensor, counts: Tensor, other_items: Tensor, other_counts: Tensor, fold: Callable = compactor_fold_plain
) -> Tuple[Tensor, Tensor]:
    """The plain version of a merge cascade. At each level the JAX package
    sorts the level with the other sketch's level and the carry from below.
    Here the other level and the carry, two ascending runs, are merged first
    (a fold whose size is their total, so nothing compacts), and the result
    is folded into the level. ``fold`` is as in :func:`fold_cascade_plain`."""
    L, k = items.shape
    carry = torch.full((2 * k,), _INF, dtype=torch.float32, device=items.device)
    carry_count = torch.zeros((), dtype=torch.int32, device=items.device)
    rows, cnts = [], []
    for lvl in range(L):
        inc, inc_count, _, _ = fold(other_items[lvl], other_counts[lvl], carry, carry_count, 3 * k)
        if lvl == L - 1:
            row, c = _absorb_top(items[lvl], counts[lvl], inc, inc_count)
        else:
            row, c, carry, carry_count = fold(items[lvl], counts[lvl], inc, inc_count, k)
        rows.append(row)
        cnts.append(c)
    return torch.stack(rows), torch.stack(cnts).to(torch.int32)


def _check_levels(items: Tensor, counts: Tensor, what: str) -> None:
    if items.ndim != 2 or counts.shape != (items.shape[0],):
        raise ValueError(f"{what} expects (L, k) items and (L,) counts, got {tuple(items.shape)} and {tuple(counts.shape)}")
    if items.dtype != torch.float32:
        raise TypeError(f"{what} runs over float32 items, got {items.dtype}")
    if items.shape[0] * items.shape[1] > _INT32_MAX:
        raise ValueError(f"{what} takes fewer than 2^31 items, got {tuple(items.shape)}")


@functools.lru_cache(maxsize=64)
def _scratch_floats(k: int, m: int, merge: bool) -> int:
    return int(_library().compactor_cascade_scratch_floats(k, m, int(merge)))


def _cascade_cuda(
    items: Tensor,
    counts: Tensor,
    inc: Optional[Tensor],
    inc_count: Optional[Tensor],
    start_level: int,
    other_items: Optional[Tensor],
    other_counts: Optional[Tensor],
) -> Tuple[Tensor, Tensor]:
    """One launch of the cascade kernel on PyTorch's current stream."""
    L, k = items.shape
    merge = other_items is not None
    items = items.contiguous()
    counts = counts.to(torch.int32).contiguous()
    if merge:
        other_items = other_items.contiguous()
        other_counts = other_counts.to(torch.int32).contiguous()
        m = 0
    else:
        inc = inc.contiguous()
        inc_count = inc_count.to(torch.int32).reshape(1).contiguous()
        m = inc.shape[0]
    out_items = torch.empty((L, k), dtype=torch.float32, device=items.device)
    out_counts = torch.empty((L,), dtype=torch.int32, device=items.device)
    lib = _library()
    n_scratch = _scratch_floats(k, m, merge)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=items.device) if n_scratch else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(items.device):
        err = lib.compactor_cascade_launch(
            items.data_ptr(), counts.data_ptr(), L, k, ptr(inc), m, ptr(inc_count), min(start_level, L),
            ptr(other_items), ptr(other_counts), out_items.data_ptr(), out_counts.data_ptr(), ptr(scratch),
            torch.cuda.current_stream(items.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"compactor_cascade kernel launch failed with cudaError {err}")
    _build.count_launch(__name__)
    return out_items, out_counts


def fold_cascade(items: Tensor, counts: Tensor, inc: Tensor, inc_count: Tensor, start_level: int) -> Tuple[Tensor, Tensor]:
    """Run ``inc`` (weight ``2**start_level``) up the level cascade.

    ``items``/``counts`` are the ``(L, k)``/``(L,)`` sketch buffers, ``inc``
    an ascending ``(M,)`` run, ``+inf`` past the 0-d ``inc_count``. Levels
    below ``start_level`` are untouched; from it up each level folds in the
    run promoted from below, and the top level absorbs and saturates at
    ``k``. Returns new ``(items, counts)``. On a CUDA tensor: one launch of
    the cascade kernel, no host read."""
    _check_levels(items, counts, "fold_cascade")
    if inc.ndim != 1 or inc.dtype != torch.float32 or inc_count.numel() != 1:
        raise ValueError(f"fold_cascade expects a 1-D float32 run and a count, got {tuple(inc.shape)} {inc.dtype}")
    if not (items.device == counts.device == inc.device == inc_count.device):
        raise ValueError(f"fold_cascade's inputs must be on one device, got {items.device}, {counts.device}, {inc.device} and {inc_count.device}")
    if start_level < 0:
        raise ValueError(f"fold_cascade needs start_level >= 0, got {start_level}")
    if items.device.type == "cpu":
        return fold_cascade_plain(items, counts, inc, inc_count.reshape(()), start_level)
    if items.device.type == "cuda":
        return _cascade_cuda(items, counts, inc, inc_count, start_level, None, None)
    raise ValueError(f"fold_cascade runs on CPU or CUDA tensors, got device {items.device}")


def merge_cascade(items: Tensor, counts: Tensor, other_items: Tensor, other_counts: Tensor) -> Tuple[Tensor, Tensor]:
    """The union of two sketches' levels, bitwise commutative. Returns new
    ``(items, counts)``. On a CUDA tensor: one launch of the cascade kernel,
    no host read."""
    _check_levels(items, counts, "merge_cascade")
    _check_levels(other_items, other_counts, "merge_cascade")
    if items.shape != other_items.shape:
        raise ValueError(f"merge_cascade needs two sketches of one shape, got {tuple(items.shape)} and {tuple(other_items.shape)}")
    if not (items.device == counts.device == other_items.device == other_counts.device):
        raise ValueError(f"merge_cascade's inputs must be on one device, got {items.device} and {other_items.device}")
    if items.device.type == "cpu":
        return merge_cascade_plain(items, counts, other_items, other_counts)
    if items.device.type == "cuda":
        return _cascade_cuda(items, counts, None, None, 0, other_items, other_counts)
    raise ValueError(f"merge_cascade runs on CPU or CUDA tensors, got device {items.device}")


def level_weights(items: Tensor, counts: Tensor) -> Tensor:
    """Per-slot row weights ``2**level`` (float32; zero past each level's
    valid prefix)."""
    L, k = items.shape
    slot_valid = torch.arange(k, device=items.device)[None, :] < counts[:, None]
    w = torch.exp2(torch.arange(L, dtype=torch.float32, device=items.device))[:, None]
    return torch.where(slot_valid, w, 0.0)


def weighted_quantiles(items: Tensor, counts: Tensor, qs: Tensor) -> Tensor:
    """Quantile values from the level buffers: one stable value order over
    all ``L * k`` slots with the weights carried through it, then a
    cumulative-weight lookup. ``+inf`` padding sorts last with zero weight."""
    vals = items.reshape(-1)
    w = level_weights(items, counts).reshape(-1)
    order = ascending_order(vals).to(torch.int64)
    sv = vals[order]
    cw = torch.cumsum(w[order], dim=0)
    total = cw[-1]
    targets = torch.clamp(qs.to(torch.float32) * total, min=1.0)
    idx = torch.clamp(torch.searchsorted(cw, targets, side="left"), 0, sv.shape[0] - 1)
    return torch.where(total > 0, sv[idx], float("nan"))


def weighted_rank(items: Tensor, counts: Tensor, v) -> Tensor:
    """Estimated number of inserted rows ``<= v`` (float32)."""
    w = level_weights(items, counts)
    v = torch.as_tensor(v, dtype=torch.float32, device=items.device)
    return torch.sum(torch.where(items <= v, w, 0.0))


def weighted_cdf(items: Tensor, counts: Tensor, points) -> Tensor:
    """Estimated CDF at many probe points in one pass: ``(P,)`` fractions of
    inserted rows ``<= points[i]``; NaN everywhere for an empty sketch."""
    w = level_weights(items, counts)
    pts = torch.atleast_1d(torch.as_tensor(points, dtype=torch.float32, device=items.device))
    ranks = torch.sum(torch.where(items[None, :, :] <= pts[:, None, None], w[None, :, :], 0.0), dim=(1, 2))
    total = torch.sum(w)
    return torch.where(total > 0, ranks / torch.clamp(total, min=1.0), float("nan"))
