"""Average precision from precision/recall curves (counterpart of
``metrics_tpu/functional/classification/average_precision.py``; this slice
carries only the step integral the binned curve metrics use).
"""
import warnings
from typing import List, Optional, Union

import torch

Tensor = torch.Tensor


def _average_precision_compute_with_precision_recall(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Union[List[Tensor], Tensor]:
    """Step-function integral of the PR curve, ``-sum(diff(recall) * precision[:-1])``.

    The per-class curves are stacked and integrated in one reduction over the
    last axis; the JAX package sums class by class, so a float32 result may
    differ from it in the last place.
    """
    if num_classes == 1:
        return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])

    p = torch.stack(list(precision))
    r = torch.stack(list(recall))
    res_arr = -torch.sum((r[:, 1:] - r[:, :-1]) * p[:, :-1], dim=-1)

    if average in ("macro", "weighted"):
        nan_mask = torch.isnan(res_arr)
        if bool(nan_mask.any()):
            warnings.warn(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
                UserWarning,
            )
        if average == "macro":
            return torch.where(nan_mask, 0.0, res_arr).sum() / torch.clamp((~nan_mask).sum(), min=1)
        weights = torch.ones_like(res_arr) if weights is None else weights
        return torch.where(nan_mask, 0.0, res_arr * weights).sum()
    if average is None or average == "none":
        return list(res_arr.unbind(0))
    allowed_average = ("micro", "macro", "weighted", None)
    raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")
