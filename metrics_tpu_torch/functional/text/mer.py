"""Match error rate (counterpart of ``metrics_tpu/functional/text/mer.py``)."""
from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _as_list, _edit_distances, _tokenize_words
from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor


def _mer_update(preds: Union[str, List[str]], target: Union[str, List[str]], device: torch.device) -> Tuple[Tensor, Tensor]:
    """Summed edit operations and total = sum of max(|pred|, |target|), float32."""
    distances, pred_lens, target_lens = _edit_distances(_as_list(preds), _as_list(target), _tokenize_words, device)
    total = torch.maximum(pred_lens, target_lens).sum()
    return distances.sum().to(torch.float32), total.to(torch.float32)


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def match_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> Tensor:
    """Match error rate: edits per aligned word slot (lower is better).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(match_error_rate(preds=preds, target=target, device="cpu")), 4)
        0.4444
    """
    errors, total = _mer_update(preds, target, resolve_device(device))
    return _mer_compute(errors, total)
