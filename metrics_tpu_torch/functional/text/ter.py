"""Translation Edit Rate (counterpart of ``metrics_tpu/functional/text/ter.py``).

Tercom algorithm (Snover et al. 2006): greedy phrase shifts that reduce the
hypothesis-to-reference edit distance, repeated until no shift helps; TER =
(shifts + final edit distance) / average reference length. The shift search
and its candidate filters are the metric's definition (tercom / sacrebleu's
``lib_ter.py``), host-side sequential work as in the JAX package, feeding two
scalar ``sum`` statistics; only the final ratio is tensor math. The edit
distance is a plain full-table DP with backtracking (no beam pruning, no
suffix cache), and the hypothesis is shifted against the reference.
"""
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000

# Ops for the alignment trace: match, substitute, hyp-only advance (extra hyp
# word), ref-only advance (missing hyp word).
_OP_MATCH, _OP_SUB, _OP_HYP, _OP_REF = 0, 1, 2, 3


class _TercomTokenizer:
    """Tercom normalizer (tercom ``Normalizer.java`` / sacrebleu ``tokenizer_ter.py`` spec)."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)
            if self.asian_support:
                sentence = re.sub(self._ASIAN_PUNCTUATION, "", sentence)
                sentence = re.sub(self._FULL_WIDTH_PUNCTUATION, "", sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general(sentence: str) -> str:
        sentence = f" {sentence} "
        for pattern, repl in (
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ):
            sentence = re.sub(pattern, repl, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        sentence = re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)
        return sentence


def _edit_distance_with_trace(hyp: List[str], ref: List[str]) -> Tuple[int, List[int]]:
    """Min edit distance + backtracked op trace, tercom tie preference.

    Ties resolve substitute/match first, then hyp-advance, then ref-advance
    (matching sacrebleu's operation preference so shift alignments agree).
    """
    m, n = len(hyp), len(ref)
    INF = 1 << 30
    cost = [[0] * (n + 1) for _ in range(m + 1)]
    op = [[_OP_REF] * (n + 1) for _ in range(m + 1)]
    for j in range(n + 1):
        cost[0][j] = j
    for i in range(1, m + 1):
        cost[i][0] = i
        op[i][0] = _OP_HYP
        row, prev = cost[i], cost[i - 1]
        for j in range(1, n + 1):
            if hyp[i - 1] == ref[j - 1]:
                diag, diag_op = prev[j - 1], _OP_MATCH
            else:
                diag, diag_op = prev[j - 1] + 1, _OP_SUB
            best, best_op = diag, diag_op
            up = prev[j] + 1
            if up < best:
                best, best_op = up, _OP_HYP
            left = row[j - 1] + 1
            if left < best:
                best, best_op = left, _OP_REF
            row[j] = best
            op[i][j] = best_op

    trace: List[int] = []
    i, j = m, n
    while i > 0 or j > 0:
        o = op[i][j]
        trace.append(o)
        if o in (_OP_MATCH, _OP_SUB):
            i -= 1
            j -= 1
        elif o == _OP_HYP:
            i -= 1
        else:
            j -= 1
    trace.reverse()
    return cost[m][n], trace


def _trace_to_alignment(trace: List[int]) -> Tuple[Dict[int, int], List[int], List[int]]:
    """ref_pos → hyp_pos alignment plus per-position error flags."""
    hyp_pos = ref_pos = -1
    alignments: Dict[int, int] = {}
    ref_errors: List[int] = []
    hyp_errors: List[int] = []
    for o in trace:
        if o == _OP_MATCH or o == _OP_SUB:
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            err = int(o == _OP_SUB)
            ref_errors.append(err)
            hyp_errors.append(err)
        elif o == _OP_HYP:
            hyp_pos += 1
            hyp_errors.append(1)
        else:  # _OP_REF
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(1)
    return alignments, ref_errors, hyp_errors


def _find_shifted_pairs(hyp: List[str], ref: List[str]):
    """Matching (hyp_start, ref_start, length) sub-spans eligible for a shift."""
    for hyp_start in range(len(hyp)):
        for ref_start in range(len(ref)):
            if abs(ref_start - hyp_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if hyp_start + length - 1 >= len(hyp) or ref_start + length - 1 >= len(ref):
                    break
                if hyp[hyp_start + length - 1] != ref[ref_start + length - 1]:
                    break
                yield hyp_start, ref_start, length
                if len(hyp) == hyp_start + length or len(ref) == ref_start + length:
                    break


def _shift_is_ineligible(
    alignments: Dict[int, int],
    hyp_errors: List[int],
    ref_errors: List[int],
    hyp_start: int,
    ref_start: int,
    length: int,
) -> bool:
    """Tercom corner cases: only shift spans that are misplaced on both sides."""
    if sum(hyp_errors[hyp_start : hyp_start + length]) == 0:
        return True
    if sum(ref_errors[ref_start : ref_start + length]) == 0:
        return True
    if hyp_start <= alignments[ref_start] < hyp_start + length:
        return True
    return False


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move ``words[start:start+length]`` so it lands at position ``target``."""
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return (
        words[:start]
        + words[start + length : length + target]
        + words[start : start + length]
        + words[length + target :]
    )


def _best_shift(
    hyp: List[str], ref: List[str], base_distance: int, checked_candidates: int
) -> Tuple[int, List[str], int]:
    """One round of tercom shift search: best gain over all candidates."""
    _, trace = _edit_distance_with_trace(hyp, ref)
    alignments, ref_errors, hyp_errors = _trace_to_alignment(trace)

    best: Optional[Tuple[int, int, int, int, List[str]]] = None
    for hyp_start, ref_start, length in _find_shifted_pairs(hyp, ref):
        if _shift_is_ineligible(alignments, hyp_errors, ref_errors, hyp_start, ref_start, length):
            continue
        prev_idx = -1
        for offset in range(-1, length):
            if ref_start + offset == -1:
                idx = 0
            elif ref_start + offset in alignments:
                idx = alignments[ref_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted = _perform_shift(hyp, hyp_start, length, idx)
            gain = base_distance - _edit_distance_with_trace(shifted, ref)[0]
            candidate = (gain, length, -hyp_start, -idx, shifted)
            checked_candidates += 1
            if best is None or candidate > best:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if best is None:
        return 0, hyp, checked_candidates
    gain, _, _, _, shifted = best
    return gain, shifted, checked_candidates


def _translation_edit_rate(hyp: List[str], ref: List[str]) -> float:
    """Edits (shifts + remaining edit distance) for one hypothesis/reference."""
    if len(ref) == 0:
        return 0.0
    num_shifts = 0
    checked_candidates = 0
    words = list(hyp)
    while True:
        base_distance, _ = _edit_distance_with_trace(words, ref)
        gain, new_words, checked_candidates = _best_shift(words, ref, base_distance, checked_candidates)
        if gain <= 0 or checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break
        num_shifts += 1
        words = new_words
    edit_distance, _ = _edit_distance_with_trace(words, ref)
    return float(num_shifts + edit_distance)


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best (lowest) edits over references + average reference length."""
    tgt_lengths = 0.0
    best_num_edits = float(2e16)
    for tgt in target_words:
        num_edits = _translation_edit_rate(pred_words, tgt)
        tgt_lengths += len(tgt)
        best_num_edits = min(best_num_edits, num_edits)
    return best_num_edits, tgt_lengths / max(len(target_words), 1)


def _score_from_statistics(num_edits: Tensor, tgt_length: Tensor) -> Tensor:
    return torch.where(
        tgt_length > 0,
        num_edits / torch.where(tgt_length > 0, tgt_length, 1.0),
        torch.where(num_edits > 0, 1.0, 0.0),
    )


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
    device: torch.device,
    collect_sentence_scores: bool = False,
) -> Tuple[Tensor, Tensor, Optional[List[Tensor]]]:
    """Summed edits and reference lengths of a batch of sentence pairs, as
    float32 scalars on ``device``; with ``collect_sentence_scores`` also
    each sentence's ``(1,)`` score, from one transfer of the batch's
    statistics."""
    if isinstance(preds, str):
        preds = [preds]
    target_corpus = [[tgt] if isinstance(tgt, str) else list(tgt) for tgt in target]
    if len(preds) != len(target_corpus):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target_corpus)}")

    total_num_edits = 0.0
    total_tgt_length = 0.0
    stats: List[Tuple[float, float]] = []
    for pred, refs in zip(preds, target_corpus):
        pred_words = tokenizer(pred.rstrip()).split()
        tgt_words = [tokenizer(ref.rstrip()).split() for ref in refs]
        num_edits, tgt_length = _compute_sentence_statistics(pred_words, tgt_words)
        total_num_edits += num_edits
        total_tgt_length += tgt_length
        stats.append((num_edits, tgt_length))
    sentence_scores: Optional[List[Tensor]] = None
    if collect_sentence_scores:
        per = torch.tensor(stats, dtype=torch.float32).reshape(-1, 2).to(device)
        sentence_scores = list(_score_from_statistics(per[:, 0], per[:, 1]).reshape(-1, 1).unbind())
    return (
        torch.full((), total_num_edits, dtype=torch.float32, device=device),
        torch.full((), total_tgt_length, dtype=torch.float32, device=device),
        sentence_scores,
    )


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    return _score_from_statistics(total_num_edits, total_tgt_length)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device, None] = None,
):
    """Corpus TER (lower is better). ``device`` is where the statistics live
    (CUDA unless the caller asks for the CPU).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(translation_edit_rate(preds, target, device="cpu")), 4)
        0.1538
    """
    for name, value in (
        ("normalize", normalize),
        ("no_punctuation", no_punctuation),
        ("lowercase", lowercase),
        ("asian_support", asian_support),
    ):
        if not isinstance(value, bool):
            raise ValueError(f"Expected argument `{name}` to be of type boolean but got {value}.")

    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    total_num_edits, total_tgt_length, sentence_scores = _ter_update(
        preds, target, tokenizer, resolve_device(device), collect_sentence_scores=return_sentence_level_score
    )
    score = _ter_compute(total_num_edits, total_tgt_length)
    if return_sentence_level_score:
        return score, sentence_scores
    return score
