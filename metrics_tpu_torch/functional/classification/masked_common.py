"""The shared prologue of the masked (``CatBuffer`` ring) curve kernels
(counterpart of ``metrics_tpu/functional/classification/masked_common.py``).

AUROC's rank statistic, average precision, ROC and the PR curve all start
from the same fixed-shape construction over a ``(cap,)`` score buffer. Its
three invariants live here once:

- rows left out by the mask are filled with ``-inf`` so they sort last, but
  valid ``-inf`` scores then tie with the fill, so every count comes from
  the VALID cumulative count (``kv``), never from the position;
- targets binarize as ``== 1`` (capacity mode fixes ``pos_label`` to 1);
- a tie group's boundary is its last valid row, and the last valid row
  overall is always a boundary (its score can equal the ``-inf`` fill);
  scores compare with denormals flushed to zero, as XLA compares them.

The cumulative counts are taken in int64 and rounded to float32 once; the
JAX package sums in float32, which is the same value below 2^24 rows.
"""
from typing import NamedTuple

import torch

from metrics_tpu_torch.ops.bucketed_rank import descending_order, flush_denormals

Tensor = torch.Tensor


class MaskedCurveParts(NamedTuple):
    s: Tensor  # scores, descending, rows left out filled with -inf
    rel: Tensor  # binarized positives in sorted order (float32)
    valid: Tensor  # validity in sorted order (bool)
    tps: Tensor  # cumulative positives (float32)
    kv: Tensor  # cumulative valid count (float32)
    boundary: Tensor  # last valid row of each tie group
    n_valid: Tensor  # int64
    n_pos: Tensor  # float32


def masked_curve_prologue(preds: Tensor, target: Tensor, mask: Tensor) -> MaskedCurveParts:
    mask = mask.to(torch.bool)
    pos = mask & (target == 1)
    score = torch.where(mask, preds.to(torch.float32), float("-inf"))

    order = descending_order(score).long()
    s = score[order]
    p = pos[order]
    v = mask[order]

    tps_i = torch.cumsum(p, 0)
    kv_i = torch.cumsum(v, 0)
    n_valid = v.sum()
    next_s = torch.cat([s[1:], torch.full((1,), float("-inf"), device=s.device)])
    boundary = v & ((flush_denormals(s) != flush_denormals(next_s)) | (kv_i == n_valid))
    return MaskedCurveParts(
        s, p.to(torch.float32), v, tps_i.to(torch.float32), kv_i.to(torch.float32), boundary,
        n_valid, p.sum().to(torch.float32),
    )
