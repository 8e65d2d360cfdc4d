"""``BLEUScore`` (counterpart of ``metrics_tpu/text/bleu.py``)."""
from typing import Any, Callable, Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class BLEUScore(Metric):
    """Corpus BLEU accumulated over batches of (preds, references).

    The state is four small float32 ``sum`` tensors; the n-gram counting is
    host work (strings), so updates run eagerly; the sync and the formula
    are tensor math on the metric's device.

    Example:
        >>> metric = BLEUScore(device="cpu")
        >>> metric.update(["the cat is on the mat"], [["the cat is on the mat"]])
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    jittable_update = False

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram

        self.add_state("preds_len", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_len", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numerator", default=torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", default=torch.zeros(n_gram), dist_reduce_fx="sum")

    def _accumulate(self, preds: Sequence[str], target_list: Sequence[Sequence[str]], tokenizer: Callable = _tokenize_fn) -> None:
        if len(preds) != len(target_list):
            raise ValueError(f"Corpus has different size {len(preds)} != {len(target_list)}")
        numerator, denominator, preds_len, target_len = _bleu_score_update(preds, target_list, self.device, self.n_gram, tokenizer)
        self.numerator += numerator
        self.denominator += denominator
        self.preds_len += preds_len
        self.target_len += target_len

    def update(self, preds: Sequence[str], target: Sequence[Union[str, Sequence[str]]]) -> None:
        preds_list = [preds] if isinstance(preds, str) else preds
        self._accumulate(preds_list, [[tgt] if isinstance(tgt, str) else tgt for tgt in target])

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator,
            self.n_gram, self.weights, self.smooth,
        )
