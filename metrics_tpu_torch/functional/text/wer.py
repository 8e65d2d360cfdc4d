"""Word error rate (counterpart of ``metrics_tpu/functional/text/wer.py``).

Tokenization is host work; the edit distances run on the metric's device as
a batched wavefront (``helper._batched_edit_distance``).
"""
from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _as_list, _edit_distances, _tokenize_words
from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor


def _wer_update(preds: Union[str, List[str]], target: Union[str, List[str]], device: torch.device) -> Tuple[Tensor, Tensor]:
    """Summed edit operations and total reference words of a batch, float32."""
    distances, _, target_lens = _edit_distances(_as_list(preds), _as_list(target), _tokenize_words, device)
    return distances.sum().to(torch.float32), target_lens.sum().to(torch.float32)


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> Tensor:
    """Word error rate: edit operations per reference word (lower is better).
    ``device`` is where the distances run (CUDA unless the caller asks for
    the CPU).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> float(word_error_rate(preds=preds, target=target, device="cpu"))
        0.5
    """
    errors, total = _wer_update(preds, target, resolve_device(device))
    return _wer_compute(errors, total)
