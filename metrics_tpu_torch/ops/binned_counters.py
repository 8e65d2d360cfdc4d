"""Binned TP/FP/FN counters per (class, threshold) (counterpart of
``metrics_tpu/ops/binned_counters.py``).

On a CUDA tensor :func:`binned_counter_update` launches the hand-written
Hopper kernel ``csrc/binned_counters.cu``, which replaces the TPU kernel
``_counter_kernel``; if it cannot, it raises. On a CPU tensor it runs
:func:`binned_counter_update_plain`, the broadcast compare-and-sum, which is
also what the kernel is checked against on the card. No switch sends a CUDA
tensor to the plain version.
"""
import ctypes
from typing import Tuple

import torch

from metrics_tpu_torch.ops import _build

Tensor = torch.Tensor

SOURCE = "binned_counters.cu"

# the kernel counts in int32 and converts to float32: exact, and equal to the
# JAX package's float32 sums, below 2^24 rows per call
MAX_ROWS = 1 << 24

# kernel launches since the last reset_launch_count(); read by chip_smoke.py
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def binned_counter_update_plain(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain version: materialises the ``(N, C, T)`` comparison and sums
    it. ``target`` is 0/1 (only ``== 1`` counts as positive)."""
    tgt = (target == 1).unsqueeze(-1)
    ge = preds.to(torch.float32).unsqueeze(-1) >= thresholds.to(torch.float32)
    tps = torch.sum(tgt & ge, dim=0).to(torch.float32)
    fps = torch.sum((~tgt) & ge, dim=0).to(torch.float32)
    fns = torch.sum(tgt & (~ge), dim=0).to(torch.float32)
    return tps, fps, fns


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.binned_counters_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _binned_counter_update_cuda(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream."""
    global launch_count
    n, c = preds.shape
    t = thresholds.shape[0]
    if n >= MAX_ROWS:
        raise ValueError(f"binned_counters takes fewer than 2^24 rows per call (exact float32 counts), got {n}")
    preds = preds.to(torch.float32).contiguous()
    tgt = (target.view(torch.uint8) if target.dtype == torch.bool else (target == 1).to(torch.uint8)).contiguous()
    thr = thresholds.to(torch.float32).contiguous()
    out = torch.zeros((3, c, t), dtype=torch.int32, device=preds.device)
    if n and c and t:
        fn = _library().binned_counters_launch
        stream = torch.cuda.current_stream(preds.device).cuda_stream
        err = fn(preds.data_ptr(), tgt.data_ptr(), thr.data_ptr(), out.data_ptr(), n, c, t, stream)
        if err != 0:
            raise RuntimeError(f"binned_counters kernel launch failed with cudaError {err}")
        launch_count += 1
    tps, fps, fns = out.to(torch.float32).unbind(0)
    return tps, fps, fns


def binned_counter_update(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """TP/FP/FN counts per (class, threshold) for one batch.

    Args:
        preds: ``(N, C)`` scores; cast to float32.
        target: ``(N, C)`` 0/1 ground truth (bool, integer or float).
        thresholds: ``(T,)`` thresholds, in any order.

    Returns:
        ``(tps, fps, fns)``, each ``(C, T)`` float32. A NaN score clears no
        threshold, so it counts as a false negative.
    """
    if preds.ndim != 2 or tuple(target.shape) != tuple(preds.shape) or thresholds.ndim != 1:
        raise ValueError(
            "binned_counters expects preds (N, C), target (N, C) and thresholds (T,); got "
            f"{tuple(preds.shape)}, {tuple(target.shape)} and {tuple(thresholds.shape)}"
        )
    if not (preds.is_floating_point() and thresholds.is_floating_point()):
        raise TypeError(f"preds and thresholds must be floating point, got {preds.dtype} and {thresholds.dtype}")
    if not (preds.device == target.device == thresholds.device):
        raise ValueError(
            f"preds, target and thresholds must be on one device, got {preds.device}, {target.device} and {thresholds.device}"
        )
    if preds.device.type == "cpu":
        return binned_counter_update_plain(preds, target, thresholds)
    if preds.device.type == "cuda":
        return _binned_counter_update_cuda(preds, target, thresholds)
    raise ValueError(f"binned_counters runs on CPU or CUDA tensors, got device {preds.device}")
