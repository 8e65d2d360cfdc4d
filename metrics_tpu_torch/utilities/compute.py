"""Numeric-safety helpers (counterpart of ``metrics_tpu/utilities/compute.py``)."""
import contextlib
import threading
from typing import Iterator

import torch

from metrics_tpu_torch.analysis.lockwitness import named_lock
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


# the blocks of full_float32 and of cusolver_linalg open in any thread, and
# the settings they found when the first of them opened
_FLOAT32_LOCK = named_lock("compute._FLOAT32_LOCK", threading.Lock(), hot=True)
_float32_depth = 0
_float32_saved = None
_linalg_depth = 0
_linalg_saved = None


@contextlib.contextmanager
def full_float32(enabled: bool = True) -> Iterator[None]:
    """Matrix products and cuDNN convolutions in full float32 inside the
    block: TF32 off, as JAX's ``Precision.HIGHEST``. The settings are the
    process's, so blocks are counted across threads: the first to open turns
    TF32 off, and the caller's settings come back only when the last one
    open ends (a thread leaving its block never turns TF32 on under
    another's). Code outside every block sees TF32 off while any block
    runs. ``enabled=False`` leaves the settings as they are; on the CPU they
    change nothing."""
    global _float32_depth, _float32_saved
    if not enabled:
        yield
        return
    with _FLOAT32_LOCK:
        if _float32_depth == 0:
            # "highest" also turns ``torch.backends.cuda.matmul.allow_tf32``
            # off, and the saved precision turns it back
            _float32_saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        _float32_depth += 1
    try:
        yield
    finally:
        with _FLOAT32_LOCK:
            _float32_depth -= 1
            if _float32_depth == 0:
                cudnn_tf32, precision = _float32_saved
                torch.set_float32_matmul_precision(precision)
                torch.backends.cudnn.allow_tf32 = cudnn_tf32


@contextlib.contextmanager
def cusolver_linalg() -> Iterator[None]:
    """Dense factorizations and solves through cuSOLVER inside the block.
    PyTorch's default picks MAGMA for batched LU and Cholesky on CUDA, whose
    batched routines allocate and synchronize, so an update that solves
    cannot be captured into a CUDA graph (the capture fails with
    ``cudaErrorStreamCaptureInvalidated``); cuSOLVER's can. The setting is
    the process's, so blocks are counted across threads as in
    :func:`full_float32`, and the caller's backend comes back when the last
    one open ends. On the CPU it changes nothing."""
    global _linalg_depth, _linalg_saved
    with _FLOAT32_LOCK:
        if _linalg_depth == 0:
            _linalg_saved = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library("cusolver")
        _linalg_depth += 1
    try:
        yield
    finally:
        with _FLOAT32_LOCK:
            _linalg_depth -= 1
            if _linalg_depth == 0:
                torch.backends.cuda.preferred_linalg_library(_linalg_saved)
