"""Word information preserved (counterpart of ``metrics_tpu/functional/text/wip.py``)."""
from typing import List, Union

import torch

from metrics_tpu_torch.functional.text.wil import _wil_update
from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor

# the same accumulated statistics as WIL
_wip_update = _wil_update


def _wip_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return (errors / target_total) * (errors / preds_total)


def word_information_preserved(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device, None] = None
) -> Tensor:
    """Word information preserved (higher is better).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_preserved(preds, target, device="cpu")), 4)
        0.3472
    """
    errors, target_total, preds_total = _wip_update(preds, target, resolve_device(device))
    return _wip_compute(errors, target_total, preds_total)
