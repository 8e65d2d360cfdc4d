"""SQuAD exact-match / F1 (counterpart of ``metrics_tpu/functional/text/squad.py``).

The official SQuAD v1.1 evaluation semantics: per-question max over ground
truths of normalized exact-match and token F1. Host string work feeding three
scalar ``sum`` statistics on the metric's device.
"""
import re
import string
from collections import Counter
from typing import Any, Dict, List, Tuple, Union

import torch

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

SINGLE_PRED_TYPE = Dict[str, str]
PREDS_TYPE = Union[SINGLE_PRED_TYPE, List[SINGLE_PRED_TYPE]]
SINGLE_TARGET_TYPE = Dict[str, Any]
TARGETS_TYPE = Union[SINGLE_TARGET_TYPE, List[SINGLE_TARGET_TYPE]]

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}

_ARTICLES_RE = re.compile(r"\b(a|an|the)\b")
_PUNC = set(string.punctuation)


def _normalize_text(text: str) -> str:
    """Lowercase; strip punctuation, articles, and extra whitespace."""
    text = "".join(ch for ch in text.lower() if ch not in _PUNC)
    return " ".join(_ARTICLES_RE.sub(" ", text).split())


def _get_tokens(text: str) -> List[str]:
    return _normalize_text(text).split() if text else []


def _f1_score(predicted_answer: str, target_answer: str) -> float:
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    if not target_tokens or not predicted_tokens:
        # no-answer case: credit only if both are empty
        return float(target_tokens == predicted_tokens)
    num_same = sum((Counter(target_tokens) & Counter(predicted_tokens)).values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return 2 * precision * recall / (precision + recall)


def _exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _squad_input_check(preds: PREDS_TYPE, targets: TARGETS_TYPE):
    """Validate and reshape inputs to {id: pred_text} + SQuAD article dicts."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]

    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key "
                f"string.\nSQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                "Please make sure that 'answer' maps to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )

    preds_dict = {pred["id"]: pred["prediction_text"] for pred in preds}
    qas = [
        {"answers": [{"text": txt} for txt in tgt["answers"]["text"]], "id": tgt["id"]}
        for tgt in targets
    ]
    return preds_dict, [{"paragraphs": [{"qas": qas}]}]


def _squad_update(preds: Dict[str, str], target: List[Dict[str, Any]], device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    """Summed F1 / exact-match (float32) and the total (int32) over a batch
    of SQuAD articles, as fills on ``device``."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
                    continue
                truths = [answer["text"] for answer in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += max(_exact_match_score(pred, truth) for truth in truths)
                f1 += max(_f1_score(pred, truth) for truth in truths)
    return (
        torch.full((), f1, dtype=torch.float32, device=device),
        torch.full((), exact_match, dtype=torch.float32, device=device),
        torch.full((), total, dtype=torch.int32, device=device),
    )


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(preds: PREDS_TYPE, target: TARGETS_TYPE, device: Union[str, torch.device, None] = None) -> Dict[str, Tensor]:
    """SQuAD v1.1 exact-match and token-F1 (scores in percent). ``device`` is
    where the statistics live (CUDA unless the caller asks for the CPU).

    Example:
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, target_dict = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_dict, resolve_device(device))
    return _squad_compute(f1, exact_match, total)
