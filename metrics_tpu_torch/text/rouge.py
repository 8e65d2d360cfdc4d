"""``ROUGEScore`` (counterpart of ``metrics_tpu/text/rouge.py``).

Each (key, stat) is a float32 running ``sum`` beside a shared sentence
count, as in the JAX package: constant memory, one collective to sync. A
batch's per-sentence values are summed in Python floats on the host and
added once to their state.
"""
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    _STATS,
    _rouge_score_update,
)
from metrics_tpu_torch.metric import Metric


class ROUGEScore(Metric):
    """Corpus ROUGE over accumulated (pred, references) pairs.
    ``use_stemmer`` needs nltk (imported at construction).

    Example:
        >>> metric = ROUGEScore(device="cpu")
        >>> out = metric(["the cat sat"], ["the cat sat down"])
        >>> round(float(out["rouge1_fmeasure"]), 4)
        0.8571
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    jittable_update = False

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if use_stemmer:
            from nltk.stem.porter import PorterStemmer

            self.stemmer = PorterStemmer()
        else:
            self.stemmer = None
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )
        if isinstance(rouge_keys, str):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate

        for key in rouge_keys:
            for stat in _STATS:
                self.add_state(f"{key}_{stat}", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sentence_count", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]
        else:
            target = [[tgt] if isinstance(tgt, str) else list(tgt) for tgt in target]
        if len(preds) != len(target):
            raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")

        results = _rouge_score_update(
            preds, target, self.rouge_keys_values, self.accumulate,
            self.stemmer, self.normalizer, self.tokenizer,
        )
        batch_sentences = 0
        for key_name, key_value in zip(self.rouge_keys, self.rouge_keys_values):
            scores = results[key_value]
            batch_sentences = len(scores)
            for stat in _STATS:
                name = f"{key_name}_{stat}"
                setattr(self, name, getattr(self, name) + sum(s[stat] for s in scores))
        self.sentence_count += batch_sentences

    def compute(self):
        count = torch.clamp(self.sentence_count, min=1.0)
        return {
            f"{key}_{stat}": getattr(self, f"{key}_{stat}") / count
            for key in self.rouge_keys
            for stat in _STATS
        }
