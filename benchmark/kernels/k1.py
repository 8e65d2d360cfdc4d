"""K1, the binned counters (``ops/binned_counters.py``,
``csrc/binned_counters.cu``), every form.

One update's work: the scores ``(n, C)`` or ``(n,)`` and the labels (class
ids, or 0/1 where the scores are ``(n,)``) once as handed, the cohort ids
where the update has ``slice_ids``, the ``thresholds`` as float32, and 4
bytes for each (cohort, class, bin, label) cell that the rows reach."""
from typing import Any, Dict, Tuple

import torch

from benchmark.harness.roofline import distinct, nbytes

NAMES = ("binned_counters",)


def work_bytes(args: Tuple[torch.Tensor, ...], kwargs: Dict[str, Any], thresholds: int = 100) -> int:
    preds, target = args[0], args[1]
    slice_ids = kwargs.get("slice_ids")
    n = preds.shape[0]
    c = preds.shape[1] if preds.ndim == 2 else 1
    t = int(thresholds)
    thr = (torch.arange(t, dtype=torch.float64, device=preds.device) / max(1, t - 1)).to(torch.float32)
    b = torch.searchsorted(thr, preds.to(torch.float32).reshape(n, c).contiguous(), right=True)
    if preds.ndim == 2:
        label = (target.to(torch.int64)[:, None] == torch.arange(c, device=preds.device)[None, :]).to(torch.int64)
    else:
        label = (target == 1).to(torch.int64)[:, None]
    if slice_ids is None:
        cohort, k = torch.zeros((n, 1), dtype=torch.int64, device=preds.device), 1
    else:
        cohort, k = slice_ids.to(torch.int64)[:, None], int(slice_ids.max()) + 1 if n else 1
    keys = ((cohort * c + torch.arange(c, device=preds.device)[None, :]) * (t + 1) + b) * 2 + label
    cells = distinct(keys.reshape(-1), k * c * (t + 1) * 2)
    return nbytes(preds) + nbytes(target) + nbytes(slice_ids) + 4 * t + 4 * cells
