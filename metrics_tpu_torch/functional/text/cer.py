"""Char error rate (counterpart of ``metrics_tpu/functional/text/cer.py``)."""
from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _as_list, _edit_distances, _tokenize_chars
from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor


def _cer_update(preds: Union[str, List[str]], target: Union[str, List[str]], device: torch.device) -> Tuple[Tensor, Tensor]:
    """Summed char-level edit operations and total reference chars, float32."""
    distances, _, target_lens = _edit_distances(_as_list(preds), _as_list(target), _tokenize_chars, device)
    return distances.sum().to(torch.float32), target_lens.sum().to(torch.float32)


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def char_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> Tensor:
    """Character error rate over reference characters (lower is better).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(char_error_rate(preds=preds, target=target, device="cpu")), 4)
        0.3415
    """
    errors, total = _cer_update(preds, target, resolve_device(device))
    return _cer_compute(errors, total)
