"""Cosine similarity (counterpart of
``metrics_tpu/functional/regression/cosine_similarity.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.compute import _to_float

Tensor = torch.Tensor


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = _to_float(preds)
    target = _to_float(target)
    _check_same_shape(preds, target)
    return preds, target


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """The similarity of each row along the last axis, then ``reduction``
    (``"sum"``, ``"mean"``, or ``"none"``/``None`` for the rows)."""
    dot_product = (preds * target).sum(dim=-1)
    preds_norm = torch.linalg.norm(preds, dim=-1)
    target_norm = torch.linalg.norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    if reduction == "sum":
        return similarity.sum()
    if reduction == "mean":
        return similarity.mean()
    if reduction in ("none", None):
        return similarity
    raise KeyError(reduction)


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Cosine similarity of the rows of ``preds`` and ``target``.

    Example:
        >>> import torch
        >>> target = torch.tensor([[0., 1], [1, 1]])
        >>> preds = torch.tensor([[0., 1], [0, 1]])
        >>> print(f"{cosine_similarity(preds, target, 'mean'):.4f}")
        0.8536
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
