"""Exact stable sort orders over orderable integer keys (counterpart of
``metrics_tpu/ops/bucketed_rank.py``; the ascending order only).

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
"""
from typing import List, Tuple

import torch

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
