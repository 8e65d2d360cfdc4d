"""BERTScore (counterpart of ``metrics_tpu/functional/text/bert.py``).

Greedy cosine matching of contextual token embeddings with optional IDF
weighting (Zhang et al., ICLR 2020): normalize, the masked ``bpd,brd->bpr``
similarity (``torch.bmm`` in full float32, no TF32), row and column maxima,
the weighted sums. Everything after the tokenizer runs on the metric's
device.

Encoder contract: ``encoder`` maps a list of sentences to ``(embeddings
(N, L, D), attention_mask (N, L), input_ids (N, L))``, tensors or numpy
arrays. A tensor output stays on its device when that is the metric's; a
numpy output moves there once (the JAX package brings every output to the
host). The real-architecture path is :class:`metrics_tpu_torch.nets.BertEncoder`,
a BERT keyed as HF ``BertModel`` checkpoints are. Precomputed dicts with
those keys work too.

Without an encoder the bundled :class:`HashTextEncoder` runs: a CRC32
hash-vocab tokenizer with a seeded random embedding table and light
neighbour mixing, bit-equal to the JAX package's. **It is not a pretrained
language model**: scores are self-consistent (identical text scores 1.0,
related text higher than unrelated) but not comparable to published
BERTScore numbers.
"""
import re
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utilities.compute import full_float32
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

_EncoderOutput = Tuple[Any, Any, Any]

#: pairs matched at once: the similarity and the normalized copies of one
#: block are the matching's only temporaries
MATCH_BLOCK_ROWS = 2048


def _strip_special_tokens(attention_mask: Tensor) -> Tensor:
    """The mask as float32 with the first token ([CLS]) and the last
    attended token ([SEP]) of each row zeroed."""
    mask = attention_mask.to(torch.float32)
    idx = torch.arange(mask.shape[1], device=mask.device)[None, :]
    last = (mask * (idx + 1)).max(dim=1).values - 1  # index of the last attended token
    mask = torch.where(idx == 0, 0.0, mask)
    return torch.where(idx == last[:, None], 0.0, mask)


def _idf_weights(input_ids: Tensor, attention_mask: Tensor) -> Tensor:
    """Corpus IDF per token id, ``log((N + 1) / (df + 1))`` over the
    reference sentences, as a float32 table on the ids' device indexed by
    id (0 for an id no reference holds). The ids and masks are read back
    once; each weight is computed in Python float64 and rounded once to
    float32, as the JAX package's are."""
    ids = input_ids.detach().cpu().numpy().astype(np.int64)
    held = attention_mask.detach().cpu().numpy() > 0
    num_docs = ids.shape[0]
    rows, cols = np.nonzero(held)
    tokens = ids[rows, cols]
    if tokens.size and tokens.min() < 0:
        raise ValueError("BERTScore's IDF weights need nonnegative token ids")
    size = int(tokens.max()) + 1 if tokens.size else 1
    # each (row, token) once: the document frequency
    distinct = np.unique(rows.astype(np.int64) * size + tokens)
    df = np.bincount(distinct % size, minlength=size)
    weight_of = {int(c): float(np.log((num_docs + 1) / (int(c) + 1))) for c in np.unique(df[df > 0])}
    table = np.zeros(size, np.float32)
    for c, w in weight_of.items():
        table[df == c] = w
    return torch.from_numpy(table).to(input_ids.device)


def _idf_scale(input_ids: Tensor, mask: Tensor, idf: Optional[Tensor]) -> Tensor:
    """Per-token weights normalized to sum 1 per sentence (uniform without
    an IDF table; an id past the table weighs 0)."""
    if idf is None:
        weights = mask.to(torch.float32)
    else:
        ids = input_ids.long()
        inside = (ids >= 0) & (ids < idf.shape[0])
        weights = torch.where(inside, idf[ids.clamp(0, idf.shape[0] - 1)], 0.0) * mask
    denom = weights.sum(dim=-1, keepdim=True)
    return weights / torch.where(denom > 0, denom, 1.0)


def _bert_score_from_embeddings(
    pred_emb: Tensor, pred_mask: Tensor, pred_scale: Tensor,
    target_emb: Tensor, target_mask: Tensor, target_scale: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy-matching precision/recall/F1 per sentence pair, in blocks of
    :data:`MATCH_BLOCK_ROWS` pairs (the pairs are independent). The two
    sides may have different token lengths."""

    def normalize(emb: Tensor, mask: Tensor) -> Tensor:
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb / torch.where(norm > 0, norm, 1.0) * mask[..., None]

    out = []
    with full_float32(pred_emb.is_cuda):
        for lo in range(0, pred_emb.shape[0], MATCH_BLOCK_ROWS):
            block = slice(lo, lo + MATCH_BLOCK_ROWS)
            cos_sim = torch.bmm(normalize(pred_emb[block], pred_mask[block]), normalize(target_emb[block], target_mask[block]).transpose(1, 2))
            precision = torch.sum(cos_sim.max(dim=2).values * pred_scale[block], dim=-1)
            recall = torch.sum(cos_sim.max(dim=1).values * target_scale[block], dim=-1)
            out.append((precision, recall))
    precision = torch.cat([p for p, _ in out]) if out else pred_emb.new_zeros((0,))
    recall = torch.cat([r for _, r in out]) if out else pred_emb.new_zeros((0,))
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * precision * recall / torch.where(denom > 0, denom, 1.0), 0.0)
    return precision, recall, f1


class HashTextEncoder:
    """Bundled offline encoder satisfying BERTScore's encoder contract, on
    the host in numpy (bit-equal to the JAX package's).

    Sentences are word/punctuation tokenized, token ids come from CRC32
    hashing into a fixed vocabulary, embeddings from a seeded random table
    (``np.random.default_rng(seed)``), and a fixed neighbour mixing
    (``0.6 * tok + 0.25 * prev + 0.15 * next``) makes tokens context
    sensitive.

    **Calibration caveat:** a structural stand-in, not a language model.
    Scores are meaningful relatively (identity = 1.0, related > unrelated)
    but not comparable to published BERTScore values.
    """

    _CLS, _SEP, _RESERVED = 1, 2, 3

    def __init__(self, dim: int = 128, vocab_size: int = 1 << 15, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        self.table = rng.standard_normal((vocab_size, dim), dtype=np.float32)
        self.vocab_size = vocab_size
        self.dim = dim

    @staticmethod
    def _tokenize(sentence: str) -> List[str]:
        return re.findall(r"\w+|[^\w\s]", sentence.lower())

    def _token_id(self, token: str) -> int:
        return self._RESERVED + zlib.crc32(token.encode("utf-8")) % (self.vocab_size - self._RESERVED)

    def __call__(self, sentences: List[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows = [[self._CLS] + [self._token_id(t) for t in self._tokenize(s)] + [self._SEP] for s in sentences]
        length = max((len(r) for r in rows), default=0)
        if length == 0:
            return (
                np.zeros((0, 0, self.dim), np.float32),
                np.zeros((0, 0), np.int64),
                np.zeros((0, 0), np.int64),
            )
        ids = np.zeros((len(rows), length), np.int64)
        mask = np.zeros((len(rows), length), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        emb = self.table[ids] * mask[..., None].astype(np.float32)
        prev_tok = np.roll(emb, 1, axis=1)
        prev_tok[:, 0] = 0
        next_tok = np.roll(emb, -1, axis=1)
        next_tok[:, -1] = 0
        emb = 0.6 * emb + 0.25 * prev_tok + 0.15 * next_tok
        return emb.astype(np.float32), mask, ids


_DEFAULT_ENCODER: Optional[HashTextEncoder] = None
_DEFAULT_ENCODER_WARNED = False


def _default_encoder() -> HashTextEncoder:
    global _DEFAULT_ENCODER, _DEFAULT_ENCODER_WARNED
    if _DEFAULT_ENCODER is None:
        _DEFAULT_ENCODER = HashTextEncoder()
    if not _DEFAULT_ENCODER_WARNED:
        rank_zero_warn(
            "BERTScore is using the bundled HashTextEncoder (deterministic hash-vocab embeddings), "
            "not a pretrained language model: scores are self-consistent but NOT comparable to "
            "published BERTScore numbers. Pass `encoder=` (e.g. metrics_tpu_torch.nets.BertEncoder "
            "with real weights) for calibrated scores.",
            UserWarning,
        )
        _DEFAULT_ENCODER_WARNED = True
    return _DEFAULT_ENCODER


def _on_device(x: Any, dtype: torch.dtype, device: torch.device) -> Tensor:
    """A tensor or array as ``dtype`` on ``device``: one transfer for a
    host array, none for a tensor already there."""
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(device=device, dtype=dtype)


def _encode(
    text: Union[Sequence[str], Dict[str, Any]],
    encoder: Optional[Callable[[List[str]], _EncoderOutput]],
    max_length: int,
    device: torch.device,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(embeddings float32, mask int32, ids int32)`` on ``device``, the
    encoder's output cut to ``max_length`` tokens (a precomputed dict is
    taken as it is)."""
    if isinstance(text, dict):
        mask = _on_device(text["attention_mask"], torch.int32, device)
        ids = text.get("input_ids")
        return (
            _on_device(text["embeddings"], torch.float32, device),
            mask,
            torch.zeros_like(mask) if ids is None else _on_device(ids, torch.int32, device),
        )
    if encoder is None:
        encoder = _default_encoder()
    emb, mask, ids = encoder(list(text))
    return (
        _on_device(emb, torch.float32, device)[:, :max_length],
        _on_device(mask, torch.int32, device)[:, :max_length],
        _on_device(ids, torch.int32, device)[:, :max_length],
    )


def _rescale(scores: Tuple[Tensor, Tensor, Tensor], baseline: Sequence[float]) -> Tuple[Tensor, Tensor, Tensor]:
    """``(x - b) / (1 - b)`` for precision, recall and F1 with their
    float32 baselines."""
    out = []
    for x, b in zip(scores, baseline):
        b32 = torch.tensor(b, dtype=torch.float32)
        out.append((x - b32.to(x.device)) / (1.0 - b32).to(x.device))
    return tuple(out)


def bert_score(
    preds: Union[Sequence[str], Dict[str, Any]],
    target: Union[Sequence[str], Dict[str, Any]],
    encoder: Optional[Callable[[List[str]], _EncoderOutput]] = None,
    idf: bool = False,
    max_length: int = 512,
    rescale_with_baseline: bool = False,
    baseline: Optional[Sequence[float]] = None,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Tensor]:
    """BERTScore precision/recall/f1 per sentence pair.

    ``baseline`` (three floats: precision/recall/f1 baselines) enables the
    rescaling ``(x - b) / (1 - b)``; no baseline files are bundled.
    ``device`` is where the matching runs (CUDA unless the caller asks for
    the CPU).

    Example (bundled HashTextEncoder; see the module docstring's
    calibration caveat):
        >>> import warnings
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore")
        ...     score = bert_score(["the cat is on the mat"], ["the cat is on the mat"], device="cpu")
        >>> round(float(score["f1"][0]), 2)
        1.0
    """
    device = resolve_device(device)
    pred_emb, pred_mask, pred_ids = _encode(preds, encoder, max_length, device)
    target_emb, target_mask, target_ids = _encode(target, encoder, max_length, device)
    if pred_emb.shape[0] != target_emb.shape[0]:
        raise ValueError("Expected the same number of predicted and reference sentences.")
    if pred_emb.shape[0] == 0:
        empty = torch.zeros((0,), dtype=torch.float32, device=device)
        return {"precision": empty, "recall": empty, "f1": empty}
    if rescale_with_baseline and baseline is None:
        raise ValueError("`rescale_with_baseline` requires the `baseline` argument (no baseline files are bundled).")

    pred_strip = _strip_special_tokens(pred_mask)
    target_strip = _strip_special_tokens(target_mask)
    idf_table = _idf_weights(target_ids, target_mask) if idf else None
    scores = _bert_score_from_embeddings(
        pred_emb, pred_strip, _idf_scale(pred_ids, pred_strip, idf_table),
        target_emb, target_strip, _idf_scale(target_ids, target_strip, idf_table),
    )
    if rescale_with_baseline:
        scores = _rescale(scores, baseline)
    return dict(zip(("precision", "recall", "f1"), scores))
