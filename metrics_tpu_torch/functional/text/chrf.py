"""chrF / chrF++ (counterpart of ``metrics_tpu/functional/text/chrf.py``).

Host side: char and word n-gram counting per sentence, and the choice of
each hypothesis's best-matching reference (the chrF spec,
https://github.com/m-popovic/chrF), whose sentence F-scores are float32
numpy. The accumulated statistics are six ``(order,)`` count tensors with
``sum`` reduction, and the corpus F-beta over the orders is one tensor
expression on the metric's device.
"""
from collections import Counter
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor

_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
_EPS_SMOOTHING = 1e-16


def _characters_of(sentence: str, whitespace: bool) -> List[str]:
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _words_of(sentence: str) -> List[str]:
    """Whitespace words with leading/trailing punctuation split off."""
    out: List[str] = []
    for word in sentence.strip().split():
        if len(word) > 1 and word[-1] in _PUNCTUATIONS:
            out.extend((word[:-1], word[-1]))
        elif len(word) > 1 and word[0] in _PUNCTUATIONS:
            out.extend((word[0], word[1:]))
        else:
            out.append(word)
    return out


def _ngram_counters(items: List[str], max_order: int) -> List[Counter]:
    """One Counter per order 1..max_order."""
    counters = []
    for order in range(1, max_order + 1):
        counters.append(Counter(tuple(items[i : i + order]) for i in range(len(items) - order + 1)))
    return counters


def _sentence_stats(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[List[Counter], List[Counter]]:
    if lowercase:
        sentence = sentence.lower()
    return (
        _ngram_counters(_characters_of(sentence, whitespace), n_char_order),
        _ngram_counters(_words_of(sentence), n_word_order),
    )


def _matches(a: List[Counter], b: List[Counter]) -> np.ndarray:
    return np.asarray([sum((x & y).values()) for x, y in zip(a, b)], np.float32)


def _totals(counters: List[Counter]) -> np.ndarray:
    return np.asarray([sum(c.values()) for c in counters], np.float32)


def _fscore_from_counts(
    matching_char: Tensor, matching_word: Tensor,
    pred_char: Tensor, pred_word: Tensor,
    target_char: Tensor, target_word: Tensor,
    n_order: float, beta: float,
) -> Tensor:
    """chrF F-beta, the mean over every char and word order (tensor math)."""
    matching = torch.cat([torch.atleast_1d(matching_char), torch.atleast_1d(matching_word)])
    pred_tot = torch.cat([torch.atleast_1d(pred_char), torch.atleast_1d(pred_word)])
    target_tot = torch.cat([torch.atleast_1d(target_char), torch.atleast_1d(target_word)])
    precision = torch.where(pred_tot > 0, matching / torch.where(pred_tot > 0, pred_tot, 1.0), 0.0)
    recall = torch.where(target_tot > 0, matching / torch.where(target_tot > 0, target_tot, 1.0), 0.0)
    denom = torch.clamp(beta**2 * precision + recall, min=_EPS_SMOOTHING)
    f_scores = (1 + beta**2) * precision * recall / denom
    return torch.sum(f_scores) / n_order


def _fscore_host(matching: np.ndarray, pred_tot: np.ndarray, target_tot: np.ndarray, n_order: float, beta: float) -> float:
    """A sentence's F-beta, the formula of :func:`_fscore_from_counts` in
    float32 numpy, its orders summed in order."""
    f32 = np.float32
    one = f32(1.0)
    precision = np.where(pred_tot > 0, matching / np.where(pred_tot > 0, pred_tot, one), f32(0.0))
    recall = np.where(target_tot > 0, matching / np.where(target_tot > 0, target_tot, one), f32(0.0))
    denom = np.maximum(f32(beta**2) * precision + recall, f32(_EPS_SMOOTHING))
    f_scores = f32(1 + beta**2) * precision * recall / denom
    total = f32(0.0)
    for f in f_scores:
        total = f32(total + f)
    return float(f32(total / f32(n_order)))


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    device: torch.device,
    collect_sentence_scores: bool = False,
):
    """Corpus chrF statistics of a batch (host counting): six float32 count
    tensors on ``device`` (char/word x matching/pred/target), from one
    transfer, and with ``collect_sentence_scores`` each sentence's ``(1,)``
    score there, else None.

    Each hypothesis is scored against every reference, and the best one's
    statistics enter the totals, starting from zero with strict
    improvement: when every reference scores 0, no target or matching
    counts enter (the pred counts always do).
    """
    if isinstance(preds, str):
        preds = [preds]
    target_corpus = [[tgt] if isinstance(tgt, str) else list(tgt) for tgt in target]
    if len(preds) != len(target_corpus):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target_corpus)}")

    n_order = float(n_char_order + n_word_order)
    matching_char = np.zeros(n_char_order, np.float32)
    matching_word = np.zeros(n_word_order, np.float32)
    pred_char = np.zeros(n_char_order, np.float32)
    pred_word = np.zeros(n_word_order, np.float32)
    target_char = np.zeros(n_char_order, np.float32)
    target_word = np.zeros(n_word_order, np.float32)
    sentence_scores: List[float] = []

    for pred, refs in zip(preds, target_corpus):
        p_char, p_word = _sentence_stats(pred, n_char_order, n_word_order, lowercase, whitespace)
        p_char_tot, p_word_tot = _totals(p_char), _totals(p_word)
        pred_char += p_char_tot
        pred_word += p_word_tot
        p_tot = np.concatenate([p_char_tot, p_word_tot])

        best = (
            0.0,
            np.zeros(n_char_order, np.float32),
            np.zeros(n_word_order, np.float32),
            np.zeros(n_char_order, np.float32),
            np.zeros(n_word_order, np.float32),
        )
        for ref in refs:
            r_char, r_word = _sentence_stats(ref, n_char_order, n_word_order, lowercase, whitespace)
            m_char, m_word = _matches(p_char, r_char), _matches(p_word, r_word)
            t_char, t_word = _totals(r_char), _totals(r_word)
            f = _fscore_host(np.concatenate([m_char, m_word]), p_tot, np.concatenate([t_char, t_word]), n_order, beta)
            if f > best[0]:
                best = (f, m_char, m_word, t_char, t_word)

        f, m_char, m_word, t_char, t_word = best
        matching_char += m_char
        matching_word += m_word
        target_char += t_char
        target_word += t_word
        sentence_scores.append(f)

    stats = torch.from_numpy(np.concatenate([matching_char, matching_word, pred_char, pred_word, target_char, target_word])).to(device)
    cut = np.cumsum([0] + [n_char_order, n_word_order] * 3)
    counts = [stats[cut[i] : cut[i + 1]] for i in range(6)]
    scores = None
    if collect_sentence_scores:
        scores = list(torch.tensor(sentence_scores, dtype=torch.float32).reshape(-1, 1).to(device).unbind())
    return (*counts, scores)


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device, None] = None,
):
    """chrF (``n_word_order=0``) / chrF++ (``n_word_order=2``, default) score.
    ``device`` is where the statistics live (CUDA unless the caller asks for
    the CPU).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> round(float(chrf_score(preds, target, device="cpu")), 4)
        0.4942
    """
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")

    device = resolve_device(device)
    m_char, m_word, p_char, p_word, t_char, t_word, sentence_scores = _chrf_score_update(
        preds, target, n_char_order, n_word_order, beta, lowercase, whitespace, device,
        collect_sentence_scores=return_sentence_level_score,
    )
    n_order = float(n_char_order + n_word_order)
    score = _fscore_from_counts(m_char, m_word, p_char, p_word, t_char, t_word, n_order, beta)
    if return_sentence_level_score:
        return score, torch.cat(sentence_scores) if sentence_scores else torch.zeros(0, device=device)
    return score
