"""BLEU score (counterpart of ``metrics_tpu/functional/text/bleu.py``).

N-gram counting is string work on the host (Python ``Counter``s); the
accumulated statistics are four small tensors (clipped-match numerator and
candidate denominator per order, the two corpus lengths) with ``sum``
reduction, so the sync and the precision / brevity-penalty / geometric-mean
formula are tensor math on the metric's device.
"""
from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor


def _count_ngram(tokens: Sequence[str], n_gram: int) -> Counter:
    """Multiset of all 1..n_gram grams of a token sequence."""
    counter: Counter = Counter()
    for order in range(1, n_gram + 1):
        for start in range(len(tokens) - order + 1):
            counter[tuple(tokens[start : start + order])] += 1
    return counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    device: torch.device,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Host n-gram statistics of a batch as float32 tensors on ``device``:
    ``(numerator, denominator, preds_len, target_len)``, the first two
    ``(n_gram,)`` clipped matches and candidate counts, the target length by
    the closest-reference-length convention (ties to the first reference)."""
    target_tokens = [[list(tokenizer(line)) if line else [] for line in refs] for refs in target]
    pred_tokens = [list(tokenizer(line)) if line else [] for line in preds]

    numerator = [0.0] * n_gram
    denominator = [0.0] * n_gram
    preds_len = 0.0
    target_len = 0.0
    for pred, refs in zip(pred_tokens, target_tokens):
        preds_len += len(pred)
        ref_lens = [len(ref) for ref in refs]
        diffs = [abs(len(pred) - ref_len) for ref_len in ref_lens]
        target_len += ref_lens[diffs.index(min(diffs))]
        pred_counter = _count_ngram(pred, n_gram)
        ref_counter: Counter = Counter()
        for ref in refs:
            ref_counter |= _count_ngram(ref, n_gram)
        clipped = pred_counter & ref_counter
        for ngram, count in clipped.items():
            numerator[len(ngram) - 1] += count
        for ngram, count in pred_counter.items():
            denominator[len(ngram) - 1] += count

    # one transfer of the batch's statistics
    stats = torch.tensor(numerator + denominator + [preds_len, target_len], dtype=torch.float32).to(device)
    return stats[:n_gram], stats[n_gram : 2 * n_gram], stats[2 * n_gram], stats[2 * n_gram + 1]


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    """Smoothed precisions, brevity penalty, weighted geometric mean; the
    zero-match exit and the penalty's condition are masks, as in JAX."""
    weights_t = torch.tensor(weights, dtype=torch.float32).to(numerator.device)
    if smooth:
        precision = (numerator + 1.0) / (denominator + 1.0)
        precision = torch.cat([(numerator[0] / denominator[0]).reshape(1), precision[1:]])
    else:
        precision = numerator / denominator

    any_zero = torch.min(numerator) == 0.0
    safe_precision = torch.where(precision > 0, precision, 1.0)  # the log's guard; masked below
    geometric_mean = torch.exp(torch.sum(weights_t * torch.log(safe_precision)))
    brevity_penalty = torch.where(preds_len > target_len, 1.0, torch.exp(1 - target_len / preds_len))
    return torch.where(any_zero, 0.0, brevity_penalty * geometric_mean)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """Corpus BLEU of machine-translated text against one or more references.
    ``device`` is where the statistics live (CUDA unless the caller asks for
    the CPU).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    preds_list = [preds] if isinstance(preds, str) else preds
    target_list = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_list) != len(target_list):
        raise ValueError(f"Corpus has different size {len(preds_list)} != {len(target_list)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds_list, target_list, resolve_device(device), n_gram
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
