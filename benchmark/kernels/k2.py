"""K2, the histogram (``ops/histogram.py``, ``csrc/histogram.cu``), as a
confusion matrix of ``num_classes`` counts it.

One update's work: one bin id a row (``target * C + pred``, the prediction
the score thresholded at ``threshold`` or the argmax), counted at the
narrowest whole-byte width of ``C * C`` bins since no implementation of that
step reads less, and 4 bytes for each bin the rows reach."""
from typing import Any, Dict, Tuple

import torch

from benchmark.harness.roofline import distinct, id_width

NAMES = ("histogram",)


def work_bytes(args: Tuple[torch.Tensor, ...], kwargs: Dict[str, Any], num_classes: int, threshold: float = 0.5) -> int:
    preds, target = args[0], args[1]
    pred = (preds >= threshold).to(torch.int64) if preds.ndim == 1 else torch.argmax(preds, dim=1)
    ids = target.to(torch.int64).reshape(-1) * int(num_classes) + pred.reshape(-1)
    bins = int(num_classes) ** 2
    return ids.numel() * id_width(bins) + 4 * distinct(ids, bins)
