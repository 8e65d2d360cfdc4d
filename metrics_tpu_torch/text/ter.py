"""``TranslationEditRate`` (counterpart of ``metrics_tpu/text/ter.py``)."""
from typing import Any, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class TranslationEditRate(Metric):
    """Corpus TER with two float32 ``sum`` states (edits, reference length).

    Example:
        >>> metric = TranslationEditRate(device="cpu")
        >>> metric.update(["the cat sat"], [["the cat sat down"]])
        >>> round(float(metric.compute()), 4)
        0.25
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    jittable_update = False

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        for name, value in (
            ("normalize", normalize),
            ("no_punctuation", no_punctuation),
            ("lowercase", lowercase),
            ("asian_support", asian_support),
        ):
            if not isinstance(value, bool):
                raise ValueError(f"Expected argument `{name}` to be of type boolean but got {value}.")
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", default=torch.tensor(0.0), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        num_edits, tgt_length, sentence_scores = _ter_update(
            preds, target, self.tokenizer, self.device, collect_sentence_scores=self.return_sentence_level_score
        )
        self.total_num_edits += num_edits
        self.total_tgt_length += tgt_length
        if self.return_sentence_level_score:
            self.sentence_ter.extend(sentence_scores)

    def compute(self):
        score = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return score, torch.cat(self.sentence_ter) if self.sentence_ter else torch.zeros(0, device=self.device)
        return score
