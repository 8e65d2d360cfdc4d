"""Shared text machinery (counterpart of ``metrics_tpu/functional/text/helper.py``).

Strings are tokenized on the host into padded int32 id tensors; the
Levenshtein distances of a batch of pairs then run on the tensors' device as
an anti-diagonal wavefront: one loop step per anti-diagonal ``k = i + j`` of
the DP table, each step a few elementwise torch ops over a ``(B, m + 1)``
tensor for the whole batch, with no read back until the caller takes the
distances. Lengths are bucketed to powers of two (minimum 8), which bounds
the number of loop lengths as it bounds JAX's compiles.
"""
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

_BIG = 1 << 30  # int32: _BIG + 1 never wraps


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to a power of two."""
    size = minimum
    while size < n:
        size *= 2
    return size


def _batched_edit_distance(pred_ids: Tensor, pred_len: Tensor, target_ids: Tensor, target_len: Tensor) -> Tensor:
    """Per-pair Levenshtein distances of padded id rows, as int32.

    ``D[i, j]`` (the cost of turning ``a[:i]`` into ``b[:j]``) is computed
    one anti-diagonal at a time from the two before it, as the JAX
    package's ``lax.scan`` does. Its clipped ``take`` becomes a ``clamp``
    of the gather's indices: index -1 reads the first id and an index past
    the end the last, which only the cells outside the table see. Each
    diagonal's value at ``i = a_len`` is kept, and the distance is the one
    at ``k = a_len + b_len``.
    """
    a, b = pred_ids, target_ids
    device = a.device
    batch, m = a.shape
    n = b.shape[1]
    idx = torch.arange(m + 1, dtype=torch.int32, device=device)
    ks = torch.arange(2, m + n + 1, dtype=torch.int32, device=device)
    # a[i - 1], and the index of b[k - i - 1] on every diagonal k >= 2,
    # clipped as jnp.take(mode="clip")
    a_i = a[:, (idx.long() - 1).clamp(0, m - 1)]
    j = ks[:, None] - idx[None, :]
    b_index = (j.long() - 1).clamp(0, n - 1)
    valid = (j >= 0) & (j <= n)
    # what overrides the recurrence: _BIG outside the table, k on its two edges
    edge = (idx[None, :] == 0) | (idx[None, :] == ks[:, None])
    override = torch.where(valid, torch.where(edge, ks[:, None], -1), _BIG).to(torch.int32)
    overridden = override >= 0

    big_col = torch.full((batch, 1), _BIG, dtype=torch.int32, device=device)
    d2 = torch.where(idx == 0, 0, _BIG).to(torch.int32).expand(batch, m + 1)  # k = 0
    d1 = torch.where(idx <= 1, 1, _BIG).to(torch.int32).expand(batch, m + 1)  # k = 1
    at_a_len = pred_len.long()[:, None]
    taps = []
    for step in range(ks.shape[0]):
        shifted_d1 = torch.cat([big_col, d1[:, :-1]], dim=1)  # D[i - 1, j]
        substitute = torch.cat([big_col, d2[:, :-1]], dim=1) + (a_i != b[:, b_index[step]])
        d = torch.minimum(substitute, torch.minimum(d1, shifted_d1) + 1)
        d = torch.where(overridden[step], override[step], d)
        taps.append(d.gather(1, at_a_len))
        d1, d2 = d, d1
    total = pred_len + target_len
    taps_t = torch.cat(taps, dim=1)
    picked = taps_t.gather(1, (total.long() - 2).clamp(min=0)[:, None])[:, 0]
    return torch.where(total <= 1, total, picked).to(torch.int32)


def _encode_batch(
    token_lists_a: Sequence[Sequence[str]], token_lists_b: Sequence[Sequence[str]], device: torch.device
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Two token batches on one throwaway integer vocabulary, padded to
    bucketed lengths and moved to ``device`` once. The pad ids differ on the
    two sides (-1 and -2), so pads never match."""
    vocab: dict = {}

    def ids_of(tokens: Sequence[str]) -> List[int]:
        out = []
        for tok in tokens:
            if tok not in vocab:
                vocab[tok] = len(vocab)
            out.append(vocab[tok])
        return out

    a_ids = [ids_of(t) for t in token_lists_a]
    b_ids = [ids_of(t) for t in token_lists_b]
    max_a = _bucket(max((len(x) for x in a_ids), default=1))
    max_b = _bucket(max((len(x) for x in b_ids), default=1))
    batch = len(a_ids)
    a_arr = np.full((batch, max_a), -1, np.int32)
    b_arr = np.full((batch, max_b), -2, np.int32)
    for row, ids in enumerate(a_ids):
        a_arr[row, : len(ids)] = ids
    for row, ids in enumerate(b_ids):
        b_arr[row, : len(ids)] = ids
    a_len = np.asarray([len(x) for x in a_ids], np.int32)
    b_len = np.asarray([len(x) for x in b_ids], np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (a_arr, a_len, b_arr, b_len))


def _edit_distances(
    preds: Sequence[str],
    target: Sequence[str],
    tokenize: Callable[[str], Sequence[str]],
    device: torch.device,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Host tokenization, then the batched wavefront on ``device``: per-pair
    ``(distances, pred_lens, target_lens)``, int32 tensors there."""
    pred_tokens = [list(tokenize(p)) for p in preds]
    target_tokens = [list(tokenize(t)) for t in target]
    a_arr, a_len, b_arr, b_len = _encode_batch(pred_tokens, target_tokens, device)
    return _batched_edit_distance(a_arr, a_len, b_arr, b_len), a_len, b_len


def _as_list(x: Union[str, List[str]]) -> List[str]:
    return [x] if isinstance(x, str) else x


def _tokenize_words(sentence: str) -> Sequence[str]:
    return sentence.split()


def _tokenize_chars(sentence: str) -> Sequence[str]:
    return list(sentence)
