"""Numeric-safety helpers (counterpart of ``metrics_tpu/utilities/compute.py``)."""
import torch

from metrics_tpu_torch.ops.bucketed_rank import ascending_order, flush_denormals

Tensor = torch.Tensor


def _to_float(x: Tensor) -> Tensor:
    """Promote integer/bool tensors to float32; pass floats through unchanged."""
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """``num/denom`` with 0 where ``denom == 0``."""
    num = _to_float(num)
    denom = _to_float(denom)
    zero = denom == 0
    return torch.where(zero, 0.0, num / torch.where(zero, 1.0, denom))


def _safe_xlogy(x: Tensor, y: Tensor) -> Tensor:
    """``x * log(y)`` that is 0 where ``x == 0``."""
    x = _to_float(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return torch.where(x == 0, 0.0, x * torch.log(torch.where(x == 0, 1.0, y)))


def _safe_matmul(x: Tensor, y: Tensor) -> Tensor:
    """Matmul that returns float32 for half-precision inputs."""
    if x.dtype in (torch.float16, torch.bfloat16) or y.dtype in (torch.float16, torch.bfloat16):
        return torch.matmul(x.to(torch.float32), y.to(torch.float32))
    return torch.matmul(x, y)


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float, axis: int = -1) -> Tensor:
    """Trapezoidal area under (x, y) with a fixed sign."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    y0 = y.narrow(axis, 0, n - 1)
    y1 = y.narrow(axis, 1, n - 1)
    return torch.sum((y0 + y1) * dx / 2.0, dim=axis) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Trapezoidal AUC with optional sorting by x (the order of
    ``jnp.argsort(x, stable=True)``)."""
    if reorder:
        order = ascending_order(x).long()
        return _auc_compute_without_check(x[order], y[order], 1.0)
    # XLA flushes float32 denormals in the subtraction and the compares
    dx = flush_denormals(torch.diff(flush_denormals(x)))
    if bool(torch.all(dx >= 0)):
        sign = 1.0
    elif bool(torch.all(dx <= 0)):
        sign = -1.0
    else:
        sign = float("nan")
    return _auc_compute_without_check(x, y, 1.0) * sign
