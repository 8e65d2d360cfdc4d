"""Binned-key precompaction of a sketch batch (counterpart of
``metrics_tpu/ops/binning.py``).

``QuantileSketchState.insert`` reduces a batch to at most ``k`` items of
weight ``2**level`` before it folds them into the level cascade: this is
the JAX package's ``precompact_batch`` (``ops/compactor.py``) in its default
``binned`` form; the legacy ``sort`` form is not ported. The batch's
values map through the orderable key of ``ops/bucketed_rank.py``; non-finite
and masked rows take the top key, where a sort by value would put a ``+inf``
fill. A value-only sort of the keys orders the batch, and the alternating-
pair halving rounds compose into one index map (:func:`halving_map`), so the
kept items are one gather of the sorted keys.

The output is bit-equal to the JAX package's: the same values in the same
slots, the same count and level. ``-0.0`` and float32 denormals come out as
``+0.0``, since they share its key.
"""
import functools
from typing import Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops.bucketed_rank import _float32_ascending_key

Tensor = torch.Tensor

_INF = float("inf")
# the signed-int32 form of the uint32 key 0xFFFFFFFF: past every finite key
# and +inf's; NaNs share it
_INVALID_KEY = 0x7FFFFFFF
_SIGN32 = 1 << 31


def key_to_float32(key: Tensor) -> Tensor:
    """Invert the ascending word (int64 values in ``[0, 2**32)``) to float32.

    The collapsed ``-0.0``/denormal key inverts to ``+0.0``, and the invalid
    key ``0xFFFFFFFF`` to a NaN."""
    key = key.to(torch.int64)
    neg = key < _SIGN32  # negative floats were stored as ~u
    u = torch.where(neg, ~key & 0xFFFFFFFF, key & 0x7FFFFFFF)
    # the float's bits as a signed int32 value, so the narrowing is exact
    u = torch.where(u >= _SIGN32, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def halving_level(n: int, k: int) -> int:
    """Number of halving rounds that an ``n``-row batch takes to fit in ``k``
    items: the level (weight exponent) of its precompacted items."""
    level = 0
    while n > k:
        n //= 2
        level += 1
    return level


def halving_map(n: int, k: int) -> Tuple[np.ndarray, int]:
    """The halving rounds composed into one index map: ``idx[j]`` is the
    position in the sorted batch of the ``j``-th kept item; and the level."""
    idx = np.arange(n, dtype=np.int64)
    level = halving_level(n, k)
    for _ in range(level):
        j = np.arange(idx.shape[0] // 2)
        idx = idx[2 * j + (j & 1)]
    return idx.astype(np.int32), level


@functools.lru_cache(maxsize=64)
def _halving_index(n: int, k: int, device: torch.device) -> Tuple[Tensor, int]:
    """:func:`halving_map` as an int64 tensor on ``device``, made once per
    ``(n, k, device)``, so that an update copies no index to the card."""
    idx, level = halving_map(n, k)
    return torch.from_numpy(idx.astype(np.int64)).to(device), level


def precompact_binned(x: Tensor, valid: Tensor, k: int) -> Tuple[Tensor, Tensor, int]:
    """Reduce a batch to at most ``k`` items of weight ``2**level``.

    Returns ``(items (min(n', k),), count, level)``: the kept items ascending
    with ``+inf`` past ``count`` (a 0-d int32 tensor), and ``level``, a
    Python int that depends on the batch size only. Non-finite and masked
    rows are dropped; an odd count drops its largest item at each round."""
    x = x.to(torch.float32).reshape(-1)
    valid = torch.broadcast_to(valid.to(torch.bool).reshape(-1), x.shape) & torch.isfinite(x)
    keys = torch.where(valid, _float32_ascending_key(x), _INVALID_KEY)
    m = torch.sum(valid, dtype=torch.int32)
    binned = torch.sort(keys).values  # value-only sort of the keys
    idx, level = _halving_index(x.shape[0], k, x.device)
    kept = key_to_float32(binned[idx].to(torch.int64) + _SIGN32)
    count = m >> level
    cur = torch.where(torch.arange(idx.shape[0], device=x.device) < count, kept, _INF)
    return cur, count, level
