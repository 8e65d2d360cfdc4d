"""Fixed-shape compactor levels of the streaming quantile sketch
(counterpart of ``metrics_tpu/ops/compactor.py``).

A sketch keeps ``L`` levels of ``k`` ascending items each, ``+inf`` past
each level's valid ``count``; an item at level ``l`` stands for ``2**l``
rows. Folding a run of items into a level merges the two; when the merge
holds more than ``k`` values the whole buffer compacts: of each adjacent
pair the item at ``2j + (j & 1)`` is promoted to the next level, and an odd
leftover stays. The kept side alternates, so the fold is a function of the
sorted values alone and merging two sketches is bitwise commutative.

:func:`compactor_fold` is kernel K3's wrapper. On a CUDA tensor it launches
``csrc/compactor_fold.cu``, which merges the two sorted runs and selects in
one launch, reading both counts from device memory; if it cannot, it raises.
On a CPU tensor it runs :func:`compactor_fold_plain`, a ``torch.sort`` of the
concatenation followed by :func:`_compactor_fold_select`, the port of the
JAX package's post-sort stage. That is also what the kernel is checked
against on the card. No switch sends a CUDA tensor to the plain version.

:func:`fold_cascade` folds a batch up the levels. The JAX package skips the
levels that the promotion does not reach with a ``lax.cond`` on the
incoming count. Here that count stays on the device: the cascade launches
the fold at every level from the batch's own up, and a fold whose incoming
count is 0 passes the level through unchanged (in the kernel, without any
search), so an update reads nothing back to the host.

Rank error: a compaction at level ``l`` moves any rank by at most ``2**l``,
so over ``n`` rows the error stays below about ``2 (L + 1) n / k``
(``QuantileSketchState.eps_bound``).
"""
import ctypes
from typing import Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops.bucketed_rank import ascending_order

Tensor = torch.Tensor

SOURCE = "compactor_fold.cu"

_INF = float("inf")
_INT32_MAX = (1 << 31) - 1

# kernel launches since the last reset_launch_count(); read by chip_smoke.py
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


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
    fn = lib.compactor_fold_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _compactor_fold_cuda(
    a: Tensor, a_count: Tensor, b: Tensor, b_count: Tensor, k: int
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Launch K3 on PyTorch's current stream."""
    global launch_count
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
    launch_count += 1
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


def fold_cascade(items: Tensor, counts: Tensor, inc: Tensor, inc_count: Tensor, start_level: int) -> Tuple[Tensor, Tensor]:
    """Run ``inc`` (weight ``2**start_level``) up the level cascade.

    ``items``/``counts`` are the ``(L, k)``/``(L,)`` sketch buffers. Levels
    below ``start_level`` are untouched; every level from it up is folded,
    and a fold with nothing incoming is the identity. The top level never
    promotes: it absorbs and saturates at ``k`` items, which
    ``QuantileSketchState.create`` makes unreachable by sizing ``L``."""
    L, k = items.shape
    rows = [items[lvl] for lvl in range(start_level)]
    cnts = [counts[lvl] for lvl in range(start_level)]
    for lvl in range(start_level, L):
        if lvl == L - 1:
            combined = torch.sort(torch.cat([items[lvl], inc])).values
            c = torch.clamp(counts[lvl] + inc_count, max=k)
            rows.append(masked_ascending(combined[:k], c))
            cnts.append(c)
            break
        new_items, new_count, inc, inc_count = fold_level(items[lvl], counts[lvl], inc, inc_count)
        rows.append(new_items)
        cnts.append(new_count)
    return torch.stack(rows), torch.stack(cnts).to(torch.int32)


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
