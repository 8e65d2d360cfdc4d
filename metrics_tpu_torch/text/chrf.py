"""``CHRFScore`` (counterpart of ``metrics_tpu/text/chrf.py``)."""
from typing import Any, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.chrf import _chrf_score_update, _fscore_from_counts
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class CHRFScore(Metric):
    """Corpus chrF/chrF++ with six per-order float32 ``sum`` count states.

    Example:
        >>> metric = CHRFScore(device="cpu")
        >>> metric.update(["the cat"], [["the cat"]])
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    jittable_update = False

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.n_order = float(n_char_order + n_word_order)
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score

        for name in ("matching", "pred", "target"):
            self.add_state(f"{name}_char", default=torch.zeros(n_char_order), dist_reduce_fx="sum")
            self.add_state(f"{name}_word", default=torch.zeros(n_word_order), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf_score", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        m_char, m_word, p_char, p_word, t_char, t_word, sentence_scores = _chrf_score_update(
            preds, target, self.n_char_order, self.n_word_order, self.beta,
            self.lowercase, self.whitespace, self.device,
            collect_sentence_scores=self.return_sentence_level_score,
        )
        self.matching_char += m_char
        self.matching_word += m_word
        self.pred_char += p_char
        self.pred_word += p_word
        self.target_char += t_char
        self.target_word += t_word
        if self.return_sentence_level_score:
            self.sentence_chrf_score.extend(sentence_scores)

    def compute(self):
        score = _fscore_from_counts(
            self.matching_char, self.matching_word, self.pred_char, self.pred_word,
            self.target_char, self.target_word, self.n_order, self.beta,
        )
        if self.return_sentence_level_score:
            if not self.sentence_chrf_score:
                return score, torch.zeros(0, device=self.device)
            return score, torch.cat(self.sentence_chrf_score)
        return score
