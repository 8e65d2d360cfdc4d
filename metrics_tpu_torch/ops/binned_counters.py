"""Binned TP/FP/FN counters per (class, threshold) (counterpart of
``metrics_tpu/ops/binned_counters.py``).

On a CUDA tensor :func:`binned_counter_update` launches the hand-written
Hopper kernel ``csrc/binned_counters.cu``, which replaces the TPU kernel
``_counter_kernel``; if it cannot, it raises. The kernel finds each score's
bin among the sorted thresholds by a binary search and counts bins in a
histogram; :func:`threshold_order` gives it the thresholds' sorted order,
which a caller with fixed thresholds computes once. On a CPU tensor it runs
:func:`binned_counter_update_plain`, the broadcast compare-and-sum, which is
also what the kernel is checked against on the card. No switch sends a CUDA
tensor to the plain version.

Both compare with float32 denormals flushed to zero, score and threshold
alike, as XLA's compares on the CPU and the TPU see them.
"""
import ctypes
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops.bucketed_rank import flush_denormals

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
    # float32 denormals compare as zero, as XLA's compares on the CPU and the TPU see them
    ge = flush_denormals(preds.to(torch.float32)).unsqueeze(-1) >= flush_denormals(thresholds.to(torch.float32))
    tps = torch.sum(tgt & ge, dim=0).to(torch.float32)
    fps = torch.sum((~tgt) & ge, dim=0).to(torch.float32)
    fns = torch.sum(tgt & (~ge), dim=0).to(torch.float32)
    return tps, fps, fns


def threshold_order(thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """The thresholds as float32 in ascending order (stable, NaN last) and
    their original positions (int32): what the kernel searches. Computed on
    the thresholds' device, with no host read."""
    values, perm = torch.sort(thresholds.to(torch.float32), stable=True)
    return values.contiguous(), perm.to(torch.int32).contiguous()


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.binned_counters_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _binned_counter_update_cuda(
    preds: Tensor, target: Tensor, thresholds: Tensor, order: Optional[Tuple[Tensor, Tensor]] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream."""
    _build.refuse_batched("K1 (ops/binned_counters.py)", preds, target, thresholds)
    n, c = preds.shape
    t = thresholds.shape[0]
    if n >= MAX_ROWS:
        raise ValueError(f"binned_counters takes fewer than 2^24 rows per call (exact float32 counts), got {n}")
    preds = preds.to(torch.float32).contiguous()
    tgt = (target.view(torch.uint8) if target.dtype == torch.bool else (target == 1).to(torch.uint8)).contiguous()
    out = torch.empty((3, c, t), dtype=torch.float32, device=preds.device)
    if c and t:
        lib = _library()
        sorted_thr, perm = threshold_order(thresholds) if order is None else order
        # the histogram (2, C, T + 1) and one finished-block counter per class tile (at most C)
        scratch = torch.zeros((2 * c * (t + 1) + c,), dtype=torch.int32, device=preds.device)
        with torch.cuda.device(preds.device):
            stream = torch.cuda.current_stream(preds.device).cuda_stream
            err = lib.binned_counters_launch(
                preds.data_ptr(), tgt.data_ptr(), sorted_thr.data_ptr(), perm.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), n, c, t, stream,
            )
        if err != 0:
            raise RuntimeError(f"binned_counters kernel launch failed with cudaError {err}")
        _build.count_launch(__name__)
    tps, fps, fns = out.unbind(0)
    return tps, fps, fns


def binned_counter_update(
    preds: Tensor, target: Tensor, thresholds: Tensor, order: Optional[Tuple[Tensor, Tensor]] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """TP/FP/FN counts per (class, threshold) for one batch.

    Args:
        preds: ``(N, C)`` scores; cast to float32.
        target: ``(N, C)`` 0/1 ground truth (bool, integer or float).
        thresholds: ``(T,)`` thresholds, in any order.
        order: ``threshold_order(thresholds)``, if the caller keeps it; else
            the kernel's wrapper computes it.

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
        return _binned_counter_update_cuda(preds, target, thresholds, order)
    raise ValueError(f"binned_counters runs on CPU or CUDA tensors, got device {preds.device}")
