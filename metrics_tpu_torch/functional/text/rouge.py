"""ROUGE score (counterpart of ``metrics_tpu/functional/text/rouge.py``).

Host side: normalization, stemming, n-gram and LCS statistics per sentence
pair (google-research/rouge semantics), in Python floats. The corpus means
are float32 tensors on the caller's device; the module form
(``text/rouge.py``) accumulates the per-sentence triples in ``sum`` states.

The sentence split of rougeLsum takes newlines first, then nltk's punkt
where nltk and its data are present, then a regex split; nltk is imported
on first use.
"""
import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.metric import resolve_device

ALLOWED_ROUGE_KEYS = {
    "rouge1": 1, "rouge2": 2, "rouge3": 3, "rouge4": 4, "rouge5": 5,
    "rouge6": 6, "rouge7": 7, "rouge8": 8, "rouge9": 9,
    "rougeL": "L", "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")

_STATS = ("fmeasure", "precision", "recall")


def _split_sentence(text: str) -> Sequence[str]:
    """Sentence-split for rougeLsum: newlines, then nltk, then regex fallback."""
    text = text.replace("<n>", "")  # pegasus newline token
    if "\n" in text:
        return [s for s in text.split("\n") if s.strip()]
    try:
        import nltk

        return nltk.sent_tokenize(text)
    except (ImportError, LookupError):
        return [s for s in re.split(r"(?<=[.!?])\s+", text) if s.strip()]


def _normalize_and_tokenize(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> List[str]:
    """Rouge text normalization: lowercase alphanumerics, optional stemming."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(tok) if len(tok) > 3 else tok for tok in tokens]
    return [tok for tok in tokens if isinstance(tok, str) and len(tok) > 0]


def _prf(hits: float, pred_len: int, target_len: int) -> Dict[str, float]:
    if pred_len == 0 or target_len == 0:
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    precision = hits / pred_len
    recall = hits / target_len
    if precision == recall == 0.0:
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    return dict(precision=precision, recall=recall, fmeasure=2 * precision * recall / (precision + recall))


def _ngram_counter(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    pred_counts, target_counts = _ngram_counter(pred, n_gram), _ngram_counter(target, n_gram)
    pred_len, target_len = sum(pred_counts.values()), sum(target_counts.values())
    hits = sum((pred_counts & target_counts).values())
    return _prf(hits, pred_len, target_len)


def _lcs_table(pred: Sequence[str], target: Sequence[str]) -> List[List[int]]:
    """The LCS table, ``table[i][j]`` over ``target[:i]`` and ``pred[:j]``:
    the JAX package's recurrence, a row at a time with its neighbours in
    locals (three times faster in CPython; ROUGE's time is this table)."""
    table = [[0] * (len(pred) + 1)]
    for t in target:
        prev, row = table[-1], [0] * (len(pred) + 1)
        for j, p in enumerate(pred):
            if t == p:
                row[j + 1] = prev[j] + 1
            else:
                up, left = prev[j + 1], row[j]
                row[j + 1] = up if up > left else left
        table.append(row)
    return table


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    if not pred or not target:
        return _prf(0.0, len(pred), len(target))
    lcs = _lcs_table(pred, target)[-1][-1]
    return _prf(lcs, len(pred), len(target))


def _backtracked_lcs_indices(pred: Sequence[str], target: Sequence[str]) -> List[int]:
    """Indices into ``target`` of one longest common subsequence."""
    table = _lcs_table(pred, target)
    i, j = len(pred), len(target)
    picked: List[int] = []
    while i > 0 and j > 0:
        if pred[i - 1] == target[j - 1]:
            picked.insert(0, j - 1)
            i -= 1
            j -= 1
        elif table[j][i - 1] > table[j - 1][i]:
            i -= 1
        else:
            j -= 1
    return picked


def _rouge_lsum_score(
    pred_sentences: Sequence[Sequence[str]], target_sentences: Sequence[Sequence[str]]
) -> Dict[str, float]:
    """Union-LCS summary score (google-research/rouge ``rouge_scorer.py``)."""
    pred_len = sum(map(len, pred_sentences))
    target_len = sum(map(len, target_sentences))
    if pred_len == 0 or target_len == 0:
        return _prf(0.0, pred_len, target_len)

    pred_counts: Counter = Counter()
    target_counts: Counter = Counter()
    for sent in pred_sentences:
        pred_counts.update(sent)
    for sent in target_sentences:
        target_counts.update(sent)

    hits = 0
    for tgt in target_sentences:
        union: set = set()
        for pred in pred_sentences:
            union.update(_backtracked_lcs_indices(pred, tgt))
        for token in (tgt[i] for i in sorted(union)):
            if pred_counts[token] > 0 and target_counts[token] > 0:
                hits += 1
                pred_counts[token] -= 1
                target_counts[token] -= 1
    return _prf(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: Sequence[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sentence rouge stats with best/avg multi-reference accumulation."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}

    for pred_raw, refs_raw in zip(preds, target):
        pred = _normalize_and_tokenize(pred_raw, stemmer, normalizer, tokenizer)
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize(s, stemmer, normalizer, tokenizer)
                for s in _split_sentence(pred_raw)
            ]

        per_ref: List[Dict[Union[int, str], Dict[str, float]]] = []
        for ref_raw in refs_raw:
            ref = _normalize_and_tokenize(ref_raw, stemmer, normalizer, tokenizer)
            scores: Dict[Union[int, str], Dict[str, float]] = {}
            for key in rouge_keys_values:
                if isinstance(key, int):
                    scores[key] = _rouge_n_score(pred, ref, key)
                elif key == "L":
                    scores[key] = _rouge_l_score(pred, ref)
                else:  # Lsum
                    ref_lsum = [
                        _normalize_and_tokenize(s, stemmer, normalizer, tokenizer)
                        for s in _split_sentence(ref_raw)
                    ]
                    scores[key] = _rouge_lsum_score(pred_lsum, ref_lsum)
            per_ref.append(scores)

        if accumulate == "best":
            first_key = rouge_keys_values[0]
            best_idx = max(range(len(per_ref)), key=lambda i: per_ref[i][first_key]["fmeasure"])
            for key in rouge_keys_values:
                results[key].append(per_ref[best_idx][key])
        else:  # avg
            for key in rouge_keys_values:
                averaged = {
                    stat: sum(ref_scores[key][stat] for ref_scores in per_ref) / len(per_ref)
                    for stat in _STATS
                }
                results[key].append(averaged)

    return results


def _rouge_score_compute(sums: Dict[str, Any], count) -> Dict[str, Any]:
    """Corpus means from accumulated sums (device math)."""
    return {name: value / count for name, value in sums.items()}


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Any]:
    """ROUGE-N / ROUGE-L / ROUGE-Lsum with precision/recall/fmeasure per key.
    ``device`` is where the float32 results live (CUDA unless the caller
    asks for the CPU).

    Example:
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> res = rouge_score(preds, target, rouge_keys="rouge1", device="cpu")
        >>> round(float(res["rouge1_fmeasure"]), 4)
        0.75
    """
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    if isinstance(rouge_keys, str):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]

    stemmer = None
    if use_stemmer:
        from nltk.stem.porter import PorterStemmer

        stemmer = PorterStemmer()

    device = resolve_device(device)
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    else:
        target = [[tgt] if isinstance(tgt, str) else list(tgt) for tgt in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")

    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer
    )
    output: Dict[str, Any] = {}
    for key_name, key_value in zip(rouge_keys, rouge_keys_values):
        scores = sentence_results[key_value]
        for stat in _STATS:
            vals = [s[stat] for s in scores]
            output[f"{key_name}_{stat}"] = torch.full((), sum(vals) / len(vals) if vals else 0.0, dtype=torch.float32, device=device)
    return output
