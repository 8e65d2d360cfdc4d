"""Exact stable sort orders over orderable integer keys, and exact global
ranks of scores sharded over processes (counterpart of
``metrics_tpu/ops/bucketed_rank.py``).

XLA's float32 sort comparator, on the CPU and the TPU, treats ``-0.0`` and
``+0.0`` as equal, flushes denormals to zero, and jax sorts NaNs of either
sign last. ``torch.sort`` of the floats does not do the first two, so the
orders here sort a monotone integer key instead, built so that its order is
XLA's float order. ``ascending_order(x)`` is then bitwise equal to
``jnp.argsort(x, stable=True)``.

The JAX package's keys are uint32 words. PyTorch has little uint32 support,
so a key word here is an int64 tensor holding the same value, in
``[0, 2**32)``. The JAX package sorts the words with a packed-radix loop of
value-only sorts; here one stable ``torch.sort`` per word does the same job.

:func:`sharded_descending_ranks` gives each process the global descending
ranks of its own scores with two small collectives (a grid agreement and one
gathered histogram) instead of gathering the scores. Its histogram pass,
:func:`bucket_counts`, runs the K2 kernel of ``ops/histogram.py`` on the
card.
"""
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from metrics_tpu_torch.ops.histogram import histogram

Tensor = torch.Tensor

_U32_MAX = 0xFFFFFFFF
_SIGN32 = 1 << 31
_SIGN64 = 1 << 63


def _float32_ascending_key(s: Tensor) -> Tensor:
    """The ascending key of float32 ``s`` as int32, with its sign bit flipped:
    signed int32 order is XLA's float32 sort order. ``-0.0`` and denormals
    take ``+0.0``'s key; NaNs of either sign take the largest."""
    i = s.to(torch.float32).view(torch.int32)
    zero_or_denormal = (i & 0x7F800000) == 0
    # non-negative floats keep their bit order; negative floats reverse it
    key = torch.where(i >= 0, i, i ^ 0x7FFFFFFF)
    key = torch.where(zero_or_denormal, torch.zeros_like(key), key)
    return torch.where(torch.isnan(s), torch.full_like(key, 0x7FFFFFFF), key)


def flush_denormals(x: Tensor) -> Tensor:
    """``x`` with float32 denormals set to zero, as XLA's CPU and TPU
    arithmetic and compares see them; other dtypes pass through. The curve
    kernels compare and subtract scores through it, so that a denormal
    score ties with zero there as it does in the JAX package."""
    if x.dtype != torch.float32:
        return x
    return torch.where((x.view(torch.int32) & 0x7F800000) == 0, torch.zeros_like(x), x)


def _float32_ascending_word(s: Tensor) -> Tensor:
    """Monotone key of float32 ``s``: the value of the JAX package's uint32
    word, as int64."""
    return _float32_ascending_key(s).to(torch.int64) + _SIGN32


def _split_words(key64: Tensor) -> List[Tensor]:
    """A 64-bit key whose unsigned order is wanted, given as int64 with the
    sign bit flipped (so signed order is that order), as two 32-bit words,
    most significant first."""
    return [(key64 >> 32) + _SIGN32, key64 & _U32_MAX]


def _key_words_ascending(x: Tensor) -> Tuple[List[Tensor], int]:
    """Key words of ``x`` (most significant first), each an int64 tensor of
    values in ``[0, 2**32)``, whose lexicographic order is the order of
    ``jnp.argsort(x)``; and the number of key bits."""
    dt = x.dtype
    if dt == torch.bool:
        return [x.to(torch.int64)], 1
    if dt.is_floating_point:
        if dt in (torch.float16, torch.bfloat16):
            # widening is monotone and keeps ties, so the order carries over
            x = x.to(torch.float32)
        if x.dtype == torch.float32:
            return [_float32_ascending_word(x)], 32
        # float64 (the JAX package reaches it only under x64)
        i = x.view(torch.int64)
        exp_mask = 0x7FF0000000000000
        i = torch.where((i & exp_mask) == 0, torch.zeros_like(i), i)
        key = torch.where(i >= 0, i, i ^ (_SIGN64 - 1))
        key = torch.where(torch.isnan(x), torch.full_like(key, _SIGN64 - 1), key)
        return _split_words(key), 64
    if dt in (torch.uint8, torch.int8, torch.int16, torch.int32):
        return [x.to(torch.int64) + (_SIGN32 if dt != torch.uint8 else 0)], 32
    if dt == torch.int64:
        return _split_words(x), 64
    raise TypeError(f"bucketed_rank has no orderable key for dtype {dt}")


def ascending_order(x: Tensor) -> Tensor:
    """Exact stable ascending order of a 1-D tensor: bitwise equal to
    ``jnp.argsort(x, stable=True)``, as int32 positions."""
    words, _ = _key_words_ascending(x.reshape(-1))
    n = words[0].shape[0]
    perm = torch.arange(n, device=x.device)
    # least significant word first: each stable pass keeps the order of the
    # words after it among ties
    for word in reversed(words):
        perm = perm[torch.sort(word[perm], stable=True).indices]
    return perm.to(torch.int32)


def descending_order(x: Tensor) -> Tensor:
    """Bitwise equal to ``jnp.argsort(-x)``: the curve kernels' descending
    order. The negation happens in the input dtype, so ``-0.0`` and NaN sign
    flips collapse in the key as the comparator collapses them, and int32
    ``INT_MIN`` wraps onto itself as in JAX."""
    if x.dtype == torch.bool:
        raise TypeError("descending_order has no negation for bool keys")
    return ascending_order(-x)


def partition_order(first: Tensor) -> Tensor:
    """Stable order with the ``first``-flagged rows first: bitwise equal to
    ``jnp.argsort(~first, stable=True)``."""
    return ascending_order(~first.to(torch.bool))


def stable_key_order(keys: Tensor, num_buckets: int) -> Tensor:
    """Stable ascending order of integer keys in ``[0, num_buckets)``: equal
    to ``jnp.argsort(keys, stable=True)``.

    The range is checked eagerly (one read of the bounds): the JAX package
    packs only the low key bits and would mis-sort a key outside it.
    """
    bits = max(1, int(num_buckets - 1).bit_length()) if num_buckets > 1 else 1
    if bits > 32:
        raise ValueError("stable_key_order supports key widths up to 32 bits")
    keys = keys.reshape(-1)
    if keys.numel():
        kmin, kmax = (int(v) for v in torch.stack([keys.min(), keys.max()]).tolist())
        if kmin < 0 or kmax >= num_buckets:
            raise ValueError(
                f"stable_key_order keys must be in [0, {num_buckets}), got [{kmin}, {kmax}] — low-bit "
                "packing would wrap them onto other buckets and silently mis-sort"
            )
    return ascending_order(keys.to(torch.int64))


def inverse_permutation(perm: Tensor) -> Tensor:
    """The inverse of a permutation of ``0..n-1``, as int32:
    ``inverse_permutation(ascending_order(x))`` equals
    ``jnp.argsort(jnp.argsort(x))``, the per-element ranks."""
    perm = perm.reshape(-1).to(torch.int64)
    ranks = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    return torch.empty_like(ranks).scatter_(0, perm, ranks)


def ascending_ranks(x: Tensor) -> Tensor:
    """Per-element stable ascending ranks of a 1-D tensor: bitwise equal to
    ``jnp.argsort(jnp.argsort(x, stable=True), stable=True)``."""
    return inverse_permutation(ascending_order(x))


def ascending_ranks_rows(x: Tensor) -> Tensor:
    """:func:`ascending_ranks` of every row of a 2-D tensor at once: bitwise
    equal to ``jax.vmap(ascending_ranks)(x)``, as int32. The rows' key
    words sort along dim 1, one stable sort per word."""
    words, _ = _key_words_ascending(x)
    n, length = x.shape
    perm = torch.arange(length, device=x.device).expand(n, length)
    for word in reversed(words):
        perm = torch.gather(perm, 1, torch.sort(torch.gather(word, 1, perm), dim=1, stable=True).indices)
    ranks = torch.arange(length, dtype=torch.int32, device=x.device).expand(n, length)
    return torch.empty((n, length), dtype=torch.int32, device=x.device).scatter_(1, perm, ranks)


def bucket_counts(
    scores: Tensor,
    lo: Tensor,
    hi: Tensor,
    num_buckets: int,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Per-bucket counts over a quantization grid of ``num_buckets`` points
    between the finite bounds ``lo`` and ``hi``; lower ids hold higher scores.

    The layout has three edge buckets, so an infinite score cannot stretch
    the grid: bucket 0 holds ``+inf``, buckets ``1..num_buckets`` the finite
    grid, bucket ``num_buckets + 1`` ``-inf``, and bucket ``num_buckets + 2``
    NaN scores together with the rows that ``valid`` leaves out (where the
    local sort's NaN fill ties them).

    Returns ``(counts, bucket_ids)``: int32 ``(num_buckets + 3,)`` counts,
    from the histogram kernel on the card, and the int32 id of every row.
    """
    scores = scores.to(torch.float32)
    finite = torch.isfinite(scores)
    zero = torch.zeros((), dtype=torch.float32, device=scores.device)
    # with no finite score lo/hi arrive as +inf/-inf; every row goes to an
    # edge bucket, but the grid arithmetic must stay finite all the same
    lo = torch.where(torch.isfinite(lo), lo, zero)
    hi = torch.where(torch.isfinite(hi), hi, zero)
    span = torch.clamp(hi - lo, min=1e-30)
    # clamp into the grid before the int cast: out-of-grid values land in
    # the buckets the id clamp gives them anyway, and a huge finite score
    # cannot overflow float32 on the way
    s = torch.minimum(torch.maximum(torch.where(finite, scores, zero), lo), hi)
    b = 1 + torch.clamp(torch.floor((hi - s) / span * num_buckets).to(torch.int32), 0, num_buckets - 1)
    b = torch.where(scores == float("inf"), 0, b)
    b = torch.where(scores == float("-inf"), num_buckets + 1, b)
    b = torch.where(torch.isnan(scores), num_buckets + 2, b)
    if valid is not None:
        b = torch.where(valid.to(torch.bool), b, num_buckets + 2)
    b = b.to(torch.int32)
    return histogram(b, num_buckets + 3), b


def _world(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """``(world size, rank)`` of ``group``; a process outside any
    ``torch.distributed`` world is a world of one."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def sharded_descending_ranks(
    scores: Tensor,
    group: Optional[dist.ProcessGroup] = None,
    num_buckets: int = 2048,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Exact global descending ranks of this process's scores among the
    scores of every process of ``group``, without gathering the scores.

    Two collectives per call: one ``all_reduce(MAX)`` of ``(-lo, hi)``
    agrees the grid over the finite valid scores, and one ``all_gather`` of
    a single int64 payload carries each rank's ``(num_buckets + 3,)``
    histogram with the per-bucket least and greatest orderable key. A row's
    rank is then its bucket's global offset, plus the rows of lower ranks
    in the same bucket, plus its position within the bucket locally.

    The global order is (score descending, rank, local position): the
    stable descending order of the rank-ordered concatenation whenever no
    bucket holds two distinct scores. ``resolved`` (a bool tensor) says
    exactly that; when it is False the ranks are still a permutation of
    ``0..N-1`` but ordered only to the bucket. Rows that ``valid`` leaves
    out rank after every valid row.

    Returns ``(ranks, resolved)``: int32 ranks of the local rows.
    """
    scores = scores.reshape(-1).to(torch.float32)
    dev = scores.device
    v = torch.ones(scores.shape, dtype=torch.bool, device=dev) if valid is None else valid.reshape(-1).to(torch.bool)
    world, rank = _world(group)

    vf = v & torch.isfinite(scores)
    inf = torch.tensor(float("inf"), device=dev)
    if scores.numel():
        bounds = torch.stack([-torch.where(vf, scores, inf).min(), torch.where(vf, scores, -inf).max()])
    else:  # a rank without rows bounds nothing
        bounds = torch.stack([-inf, -inf])
    if world > 1:
        dist.all_reduce(bounds, op=dist.ReduceOp.MAX, group=group)
    lo, hi = -bounds[0], bounds[1]

    counts, b = bucket_counts(scores, lo, hi, num_buckets, valid=v)

    # the least and greatest orderable key per bucket, for the collision
    # check; the NaN fill is the local sort's, so left-out rows and NaN
    # scores share one key in the overflow bucket
    nb = num_buckets + 3
    key = _float32_ascending_word(torch.where(v, -scores, float("nan")))
    bl = b.to(torch.int64)
    kmin = torch.full((nb,), _U32_MAX, dtype=torch.int64, device=dev).scatter_reduce(0, bl, key, "amin")
    kmax = torch.zeros(nb, dtype=torch.int64, device=dev).scatter_reduce(0, bl, key, "amax")

    payload = torch.cat([counts.to(torch.int64), kmin, kmax])
    if world > 1:
        parts = [torch.empty_like(payload) for _ in range(world)]
        dist.all_gather(parts, payload, group=group)
        gathered = torch.stack(parts)
    else:
        gathered = payload.unsqueeze(0)
    counts_g = gathered[:, :nb]
    gmin = gathered[:, nb:2 * nb].amin(dim=0)
    gmax = gathered[:, 2 * nb:].amax(dim=0)

    totals = counts_g.sum(dim=0)
    offsets = torch.cumsum(totals, 0) - totals
    below = counts_g[:rank].sum(dim=0)

    # within-bucket positions from the local order; left-out rows are NaN,
    # which sorts after every valid score, -inf included
    local_rank = inverse_permutation(descending_order(torch.where(v, scores, float("nan"))))
    local_offsets = torch.cumsum(counts, 0) - counts
    within = local_rank.to(torch.int64) - local_offsets[bl]

    ranks = (offsets[bl] + below[bl] + within).to(torch.int32)
    resolved = torch.all((gmin == gmax) | (totals <= 1))
    return ranks, resolved
