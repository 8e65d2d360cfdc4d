"""Extended Edit Distance (counterpart of ``metrics_tpu/functional/text/eed.py``).

EED (Stanchev, Wang, Ney, WMT 2019): a CDER-style character-level DP with a
long jump at blanks and a coverage penalty. One DP row update is vectorized
as in the JAX package: the deletion chain ``next[i] = min(next[i-1] + del,
base[i])`` is the prefix minimum ``min_j (base[j] - j * del) + i * del``
(``torch.cummin``), the long jump a broadcast of the row minimum. The DP is
one loop over reference characters, each step a few torch ops over a
``(B, |hyp| + 1)`` tensor for every (hypothesis, reference) pair at once, on
the pairs' device.
"""
import re
import unicodedata
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _bucket
from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.ops.bucketed_rank import flush_denormals

Tensor = torch.Tensor

_INF = 1e30  # float32


def _eed_batch(
    hyp_ids: Tensor, hyp_len: Tensor, ref_ids: Tensor, ref_len: Tensor,
    alpha: float, rho: float, deletion: float, insertion: float,
) -> Tensor:
    """EED score of each padded (hyp, ref) codepoint pair, float32.

    The row minimum's index is the first one (``torch.argmin``, as
    ``jnp.argmin``), taken over the row with float32 denormals flushed, as
    XLA compares them: the coverage count depends on which index wins a tie.
    """
    device = hyp_ids.device
    batch, h_cap = hyp_ids.shape
    f32 = torch.float32
    idx = torch.arange(h_cap + 1, device=device)
    valid = idx[None, :] <= hyp_len[:, None].long()  # positions 0..hyp_len are live
    idx_del = idx.to(f32) * deletion
    inf = torch.full((), _INF, dtype=f32, device=device)

    row = torch.where(valid, torch.where(idx == 0, 0.0, 1.0).to(f32), inf)
    visits = torch.full((batch, h_cap + 1), -1, dtype=torch.int32, device=device)
    # hyp char i - 1 aligned to position i
    hyp_chars = torch.cat([torch.zeros((batch, 1), dtype=hyp_ids.dtype, device=device), hyp_ids], dim=1)
    inf_col = inf.expand(batch, 1)
    is_first = idx == 0
    active = torch.arange(ref_ids.shape[1], device=device)[None, :] < ref_len[:, None].long()
    is_space = ref_ids == ord(" ")
    rows = torch.arange(batch, device=device)
    for w in range(ref_ids.shape[1]):
        # substitution / match against hyp char i - 1, or an insertion
        sub_cost = (hyp_chars != ref_ids[:, w : w + 1]).to(f32)
        shifted_row = torch.cat([inf_col, row[:, :-1]], dim=1)  # row[i - 1]
        base = torch.minimum(shifted_row + sub_cost, row + insertion)
        base = torch.where(is_first, row + 1.0, base)
        base = torch.where(valid, base, inf)
        # deletion chain as a prefix minimum
        next_row = torch.cummin(base - idx_del, dim=1).values + idx_del
        next_row = torch.where(valid, next_row, inf)
        # coverage bookkeeping: the first index achieving the row minimum
        row_min = next_row.min(dim=1, keepdim=True).values
        min_index = torch.argmin(flush_denormals(next_row), dim=1)
        w_active = active[:, w]
        visits = visits.index_put((rows, min_index), w_active.to(torch.int32), accumulate=True)
        # long jump at blanks
        jumped = torch.minimum(next_row, alpha + row_min)
        next_row = torch.where(is_space[:, w : w + 1], jumped, next_row)
        next_row = torch.where(valid, next_row, inf)
        # padded ref steps leave the row untouched
        row = torch.where(w_active[:, None], next_row, row)

    counted = torch.where(valid, torch.where(visits >= 0, visits, 1), 0).to(f32)
    coverage = rho * counted.sum(dim=1)
    errors = row.gather(1, hyp_len.long()[:, None])[:, 0]
    return torch.clamp((errors + coverage) / (ref_len.to(f32) + coverage), max=1.0)


def _encode_chars(strings: Sequence[str], cap: int, device: torch.device) -> Tuple[Tensor, Tensor]:
    arr = np.full((len(strings), cap), -1, np.int32)
    for row, s in enumerate(strings):
        codes = [ord(c) for c in s][:cap]
        arr[row, : len(codes)] = codes
    lens = np.asarray([min(len(s), cap) for s in strings], np.int32)
    return torch.from_numpy(arr).to(device), torch.from_numpy(lens).to(device)


def _preprocess_en(sentence: str) -> str:
    """EED English normalization (rwth-i6/ExtendedEditDistance ``util.py`` spec)."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, repl in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, repl)
    sentence = re.sub(r"\s+", " ", sentence)
    sentence = re.sub(r"(\d) ([.,]) (\d)", r"\1\2\3", sentence)
    sentence = re.sub(r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1.", sentence)
    for pattern, repl in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, repl)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    device: torch.device,
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> Tensor:
    """Per-sentence EED scores (the lowest over each sentence's references),
    a float32 ``(N,)`` tensor on ``device``. Every (hyp, ref) pair of the
    batch runs through one batched DP."""
    if isinstance(preds, str):
        preds = [preds]
    target_corpus = [[tgt] if isinstance(tgt, str) else list(tgt) for tgt in target]
    if len(preds) != len(target_corpus):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target_corpus)}")
    if len(preds) == 0 or any(len(refs) == 0 for refs in target_corpus):
        return torch.zeros((0,), dtype=torch.float32, device=device)

    if language == "en":
        preprocess = _preprocess_en
    elif language == "ja":
        preprocess = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")

    hyp_strings: List[str] = []
    ref_strings: List[str] = []
    pair_owner: List[int] = []
    for i, (pred, refs) in enumerate(zip(preds, target_corpus)):
        pred_p = preprocess(pred)
        for ref in refs:
            hyp_strings.append(pred_p)
            ref_strings.append(preprocess(ref))
            pair_owner.append(i)

    h_cap = _bucket(max(len(s) for s in hyp_strings))
    r_cap = _bucket(max(len(s) for s in ref_strings))
    hyp_ids, hyp_len = _encode_chars(hyp_strings, h_cap, device)
    ref_ids, ref_len = _encode_chars(ref_strings, r_cap, device)
    scores = _eed_batch(hyp_ids, hyp_len, ref_ids, ref_len, alpha, rho, deletion, insertion)
    owner = torch.tensor(pair_owner, dtype=torch.int64, device=device)
    best = torch.full((len(preds),), float("inf"), dtype=torch.float32, device=device)
    return best.scatter_reduce(0, owner, scores, reduce="amin")


def _eed_compute(sentence_level_scores: Tensor) -> Tensor:
    if sentence_level_scores.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=sentence_level_scores.device)
    return sentence_level_scores.sum() / sentence_level_scores.numel()


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Union[str, torch.device, None] = None,
):
    """Extended edit distance (lower is better; scores in [0, 1]). With
    ``return_sentence_level_score`` also the list of per-sentence 0-d
    scores. ``device`` is where the DP runs (CUDA unless the caller asks for
    the CPU).

    Example:
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> round(float(extended_edit_distance(preds=preds, target=target, device="cpu")), 4)
        0.3078
    """
    for name, value in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(value, float) or value < 0:
            raise ValueError(f"Parameter `{name}` is expected to be a non-negative float.")

    sentence_scores = _eed_update(preds, target, resolve_device(device), language, alpha, rho, deletion, insertion)
    average = _eed_compute(sentence_scores)
    if return_sentence_level_score:
        return average, list(sentence_scores.unbind())
    return average
