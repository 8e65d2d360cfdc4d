"""Word information lost (counterpart of ``metrics_tpu/functional/text/wil.py``).

Uses the hit approximation ``hits = sum max(|pred|, |tgt|) - sum edits``
(stored negated, as ``errors - total``), as the JAX package does.
"""
from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _as_list, _edit_distances, _tokenize_words
from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor


def _wil_update(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: torch.device
) -> Tuple[Tensor, Tensor, Tensor]:
    """(edits - max-len total, total target words, total pred words), float32."""
    distances, pred_lens, target_lens = _edit_distances(_as_list(preds), _as_list(target), _tokenize_words, device)
    total = torch.maximum(pred_lens, target_lens).sum()
    errors = distances.sum() - total
    return errors.to(torch.float32), target_lens.sum().to(torch.float32), pred_lens.sum().to(torch.float32)


def _wil_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return 1 - ((errors / target_total) * (errors / preds_total))


def word_information_lost(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> Tensor:
    """Word information lost (lower is better).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_lost(preds, target, device="cpu")), 4)
        0.6528
    """
    errors, target_total, preds_total = _wil_update(preds, target, resolve_device(device))
    return _wil_compute(errors, target_total, preds_total)
