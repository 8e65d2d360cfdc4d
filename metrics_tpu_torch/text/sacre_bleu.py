"""``SacreBLEUScore`` (counterpart of ``metrics_tpu/text/sacre_bleu.py``)."""
from typing import Any, Optional, Sequence

from metrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer
from metrics_tpu_torch.text.bleu import BLEUScore


class SacreBLEUScore(BLEUScore):
    """BLEU with the standardized sacrebleu tokenization.

    Example:
        >>> metric = SacreBLEUScore(device="cpu")
        >>> metric.update(["the cat is on the mat"], [["the cat is on the mat"]])
        >>> round(float(metric.compute()), 4)
        1.0
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        self._accumulate(preds, [[tgt] if isinstance(tgt, str) else tgt for tgt in target], self.tokenizer)
