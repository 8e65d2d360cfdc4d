"""``ExtendedEditDistance`` (counterpart of ``metrics_tpu/text/eed.py``).

The state is a running (sum, count) pair, with the per-sentence list kept
only when sentence-level scores are asked for, as in the JAX package.
"""
from typing import Any, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.eed import _eed_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class ExtendedEditDistance(Metric):
    """Corpus EED over accumulated (preds, references) pairs.

    Example:
        >>> metric = ExtendedEditDistance(device="cpu")
        >>> metric.update(["the cat sat"], [["the cat sat down"]])
        >>> round(float(metric.compute()), 4)
        0.3434
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    jittable_update = False

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        for name, value in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
            if not isinstance(value, float) or value < 0:
                raise ValueError(f"Parameter `{name}` is expected to be a non-negative float.")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("score_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sentence_count", default=torch.tensor(0.0), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_eed", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_update(
            preds, target, self.device, self.language, self.alpha, self.rho, self.deletion, self.insertion
        )
        self.score_sum += scores.sum()
        self.sentence_count += scores.numel()
        if self.return_sentence_level_score:
            self.sentence_eed.extend(scores.reshape(-1, 1).unbind())

    def compute(self):
        average = self.score_sum / torch.clamp(self.sentence_count, min=1.0)
        if self.return_sentence_level_score:
            return average, torch.cat(self.sentence_eed) if self.sentence_eed else torch.zeros(0, device=self.device)
        return average
