"""Area under a curve by the trapezoid rule (counterpart of
``metrics_tpu/functional/classification/auc.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.ops.bucketed_rank import ascending_order, flush_denormals
from metrics_tpu_torch.utilities.compute import _auc_compute

Tensor = torch.Tensor


def _auc_update(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """Shape checks: two 1-D tensors of one shape."""
    if x.ndim > 1:
        x = x.squeeze()
    if y.ndim > 1:
        y = y.squeeze()
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimension {x.ndim} and {y.ndim}")
    if x.shape != y.shape:
        raise ValueError(f"Expected the same shape for `x` and `y` tensors, but got {tuple(x.shape)} and {tuple(y.shape)}")
    return x, y


def _auc_compute_masked(x: Tensor, y: Tensor, mask: Tensor, reorder: bool = False) -> Tensor:
    """Trapezoid area over the rows where ``mask`` is True, in fixed shapes.

    The rows left out go to the tail by a stable sort (on ``x`` when
    ``reorder``, else on position), and a segment with such an end adds
    nothing: the area of the valid rows alone.
    """
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    mask = mask.to(torch.bool)
    n = x.shape[0]
    inf = torch.tensor(float("inf"), device=x.device)
    key = x if reorder else torch.arange(n, dtype=torch.float32, device=x.device)
    order = ascending_order(torch.where(mask, key, inf)).long()
    x_s, y_s, m_s = x[order], y[order], mask[order]
    valid_pair = m_s[:-1] & m_s[1:]
    # XLA flushes float32 denormals in the subtraction and the compares
    dx = torch.where(valid_pair, flush_denormals(torch.diff(flush_denormals(x_s))), 0.0)
    area = torch.sum(torch.where(valid_pair, (y_s[:-1] + y_s[1:]) * dx / 2.0, 0.0))
    if reorder:
        return area
    # the direction, from the valid pairs only (a left-out dx is 0)
    nan = torch.tensor(float("nan"), device=x.device)
    sign = torch.where(torch.all(dx >= 0), 1.0, torch.where(torch.all(dx <= 0), -1.0, nan))
    return area * sign


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under the curve by the trapezoid rule.

    Example:
        >>> import torch
        >>> x = torch.tensor([0, 1, 2, 3])
        >>> y = torch.tensor([0, 1, 2, 2])
        >>> auc(x, y)
        tensor(4.)
    """
    x, y = _auc_update(torch.as_tensor(x), torch.as_tensor(y))
    return _auc_compute(x.to(torch.float32), y.to(torch.float32), reorder=reorder)
