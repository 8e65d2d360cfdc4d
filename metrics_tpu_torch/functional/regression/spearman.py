"""Spearman rank correlation (counterpart of
``metrics_tpu/functional/regression/spearman.py``).

A value's rank is the mean of its tie span,
``(#{x_j < x_i} + 1 + #{x_j <= x_i}) / 2``, from one sort and two binary
searches. The sort and the searches run over the orderable int32 keys of
``ops/bucketed_rank.py`` (stated watch item W1): XLA's float compare, which
the JAX package's sort and search use, ties ``-0.0`` with ``+0.0`` and
flushes denormals to zero, and ``torch.sort``/``torch.searchsorted`` over
the floats would do neither. NaN takes the largest key, as it sorts last in
the JAX package. Floating inputs rank in float32, integer inputs as they
are (the JAX package has no float64).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.bucketed_rank import _float32_ascending_key
from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor

_INF_KEY = 0x7F800000  # the key of +inf: a positive float keeps its bits


def _rank_keys(data: Tensor) -> Tensor:
    if data.is_floating_point():
        return _float32_ascending_key(data).to(torch.int64)
    return data.to(torch.int64)


def _rank_data(data: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """1-based ranks, ties given the mean of their span. With ``mask``,
    only the True rows take part: the others sort as ``+inf`` and the
    ``<=`` count is capped at the valid rows, so that ``+inf`` data does not
    absorb them. Ranks at masked rows mean nothing."""
    data = torch.as_tensor(data)
    keys = _rank_keys(data)
    if mask is None:
        sorted_keys = torch.sort(keys).values
        lt = torch.searchsorted(sorted_keys, keys, side="left")
        le = torch.searchsorted(sorted_keys, keys, side="right")
    else:
        fill = _INF_KEY if data.is_floating_point() else torch.iinfo(torch.int64).max
        sorted_keys = torch.sort(torch.where(mask, keys, fill)).values
        lt = torch.searchsorted(sorted_keys, keys, side="left")
        le = torch.minimum(torch.searchsorted(sorted_keys, keys, side="right"), mask.sum())
    dtype = data.dtype if data.dtype == torch.float64 else torch.float32
    return (lt + 1 + le).to(dtype) / 2.0


def _spearman_corrcoef_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    preds = preds.squeeze()
    target = target.squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _spearman_masked(preds: Tensor, target: Tensor, mask: Tensor, eps: float = 1e-6) -> Tensor:
    """The correlation of the masked rows of a ring pair; NaN when no row
    is valid."""
    return _spearman_corrcoef_compute(preds.to(torch.float32), target.to(torch.float32), eps, mask=mask.to(torch.bool))


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6, mask: Optional[Tensor] = None) -> Tensor:
    """One weighted form for both modes: unit weights without ``mask``, the
    mask's with it."""
    rp = _rank_data(preds, mask)
    rt = _rank_data(target, mask)
    w = torch.ones_like(rp) if mask is None else mask.to(rp.dtype)
    n = w.sum()
    n_safe = torch.clamp(n, min=1.0)

    mean_p = (rp * w).sum() / n_safe
    mean_t = (rt * w).sum() / n_safe
    dp = (rp - mean_p) * w
    dt = (rt - mean_t) * w

    cov = (dp * dt).sum() / n_safe
    std_p = torch.sqrt((dp * dp).sum() / n_safe)
    std_t = torch.sqrt((dt * dt).sum() / n_safe)

    corrcoef = torch.clamp(cov / (std_p * std_t + eps), -1.0, 1.0)
    if mask is None:
        return corrcoef
    return torch.where(n > 0, corrcoef, float("nan"))


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation of two 1-d tensors.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> print(f"{spearman_corrcoef(preds, target):.4f}")
        1.0000
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)
