"""``BERTScore`` (counterpart of ``metrics_tpu/text/bert.py``).

The injected encoder runs on update and the metric keeps its embeddings,
masks and ids as ``cat`` list states on its device; compute matches them
there (IDF needs the whole reference corpus, hence compute-time weights).
The JAX package pads and concatenates on the host; here each side's items
are padded on the device to that side's longest, and only the ids and
masks that IDF needs are read back, only with ``idf=True``.

Batches of different token lengths sync (ROADMAP F10, D50): before a sync
each list state's items are padded in their token dimension to the
longest on this rank, so the rank's concatenation exists; the ragged
gather pads across ranks as for any list state. Padded tokens have mask 0
and add nothing. The JAX package's sync raises on such batches, and other
list states of the port keep that behaviour.
"""
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.bert import (
    _bert_score_from_embeddings,
    _encode,
    _idf_scale,
    _idf_weights,
    _rescale,
    _strip_special_tokens,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor

_LIST_STATES = ("pred_embeddings", "pred_masks", "pred_ids", "target_embeddings", "target_masks", "target_ids")


def _pad_tokens(x: Tensor, length: int) -> Tensor:
    """``x`` zero-padded in its token dimension (dim 1) to ``length``."""
    if x.shape[1] == length:
        return x
    return torch.nn.functional.pad(x, [0, 0] * (x.ndim - 2) + [0, length - x.shape[1]])


def _cat_padded(items: List[Tensor]) -> Tensor:
    """The items padded to their longest token length and concatenated."""
    length = max(t.shape[1] for t in items)
    return torch.cat([_pad_tokens(t, length) for t in items])


class BERTScore(Metric):
    """Accumulating BERTScore.

    With ``encoder=None`` the bundled :class:`~metrics_tpu_torch.functional.text.bert.HashTextEncoder`
    runs: deterministic hash-vocab embeddings, NOT a pretrained language
    model (identity = 1.0, related > unrelated, but not comparable to
    published BERTScore numbers), and a warning says so once. Inject
    ``encoder=`` (e.g. :class:`metrics_tpu_torch.nets.BertEncoder` with
    real weights) for calibrated scores.

    Example (bundled encoder; identical pairs score 1.0 by construction):
        >>> import warnings
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore")
        ...     metric = BERTScore(device="cpu")
        ...     metric.update(["the cat sat on the mat"], ["the cat sat on the mat"])
        >>> {k: round(float(v.mean()), 4) for k, v in metric.compute().items()}
        {'precision': 1.0, 'recall': 1.0, 'f1': 1.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    jittable_update = False

    def __init__(
        self,
        encoder: Optional[Callable[[List[str]], Tuple[Any, Any, Any]]] = None,
        idf: bool = False,
        max_length: int = 512,
        rescale_with_baseline: bool = False,
        baseline: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.encoder = encoder
        self.idf = idf
        self.max_length = max_length
        if rescale_with_baseline and baseline is None:
            raise ValueError(
                "`rescale_with_baseline` requires the `baseline` argument (no baseline files are bundled)."
            )
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline = baseline
        for name in _LIST_STATES:
            self.add_state(name, default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[Sequence[str], Dict[str, Any]], target: Union[Sequence[str], Dict[str, Any]]) -> None:
        pred_emb, pred_mask, pred_ids = _encode(preds, self.encoder, self.max_length, self.device)
        target_emb, target_mask, target_ids = _encode(target, self.encoder, self.max_length, self.device)
        if pred_emb.shape[0] != target_emb.shape[0]:
            raise ValueError("Expected the same number of predicted and reference sentences.")
        self.pred_embeddings.append(pred_emb)
        self.pred_masks.append(pred_mask)
        self.pred_ids.append(pred_ids)
        self.target_embeddings.append(target_emb)
        self.target_masks.append(target_mask)
        self.target_ids.append(target_ids)

    def _state_for_sync(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """F10: each list state's items padded to the rank's longest token
        length, so that they concatenate (new lists; the state is kept)."""
        state = dict(super()._state_for_sync(state))
        for name in _LIST_STATES:
            items = state[name]
            if len(items) > 1:
                length = max(t.shape[1] for t in items)
                state[name] = [_pad_tokens(t, length) for t in items]
        return state

    def compute(self) -> Dict[str, Tensor]:
        pred_emb = _cat_padded(self.pred_embeddings)
        pred_mask = _strip_special_tokens(_cat_padded(self.pred_masks))
        target_emb = _cat_padded(self.target_embeddings)
        target_mask_raw = _cat_padded(self.target_masks)
        target_mask = _strip_special_tokens(target_mask_raw)
        pred_ids = _cat_padded(self.pred_ids)
        target_ids = _cat_padded(self.target_ids)
        idf_table = _idf_weights(target_ids, target_mask_raw) if self.idf else None
        scores = _bert_score_from_embeddings(
            pred_emb, pred_mask, _idf_scale(pred_ids, pred_mask, idf_table),
            target_emb, target_mask, _idf_scale(target_ids, target_mask, idf_table),
        )
        if self.rescale_with_baseline:
            scores = _rescale(scores, self.baseline)
        return dict(zip(("precision", "recall", "f1"), scores))
