"""KL(P || Q) (counterpart of
``metrics_tpu/functional/classification/kl_divergence.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.compute import _safe_xlogy

Tensor = torch.Tensor


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    """Per-row divergences ``(N,)`` and the row count."""
    p = torch.as_tensor(p)
    q = torch.as_tensor(q)
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")

    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / p.sum(dim=-1, keepdim=True)
        q = q / q.sum(dim=-1, keepdim=True)
        measures = _safe_xlogy(p, p / q).sum(dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total: Tensor, reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return measures.sum()
    if reduction == "mean":
        return measures.sum() / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: Optional[str] = "mean") -> Tensor:
    """KL(P || Q) between the rows of ``p`` and ``q``.

    Example:
        >>> import torch
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> kl_divergence(p, q).round(decimals=4)
        tensor(0.0853)
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
