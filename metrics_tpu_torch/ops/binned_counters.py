"""Binned TP/FP/FN counters per (class, threshold) (counterpart of
``metrics_tpu/ops/binned_counters.py``).

On a CUDA tensor :func:`binned_counter_update` launches the hand-written
Hopper kernel ``csrc/binned_counters.cu``, which replaces the TPU kernel
``_counter_kernel``; if it cannot, it raises. The kernel finds each score's
bin among the sorted thresholds and counts bins in a histogram;
:func:`threshold_order` gives it the thresholds' sorted order, which a
caller with fixed thresholds computes once. A plan from the shapes picks
the kernel's design before the launch: few classes and many rows (C at most
8, N * C times the lanes at least 2^20, T at most 8,191: a pixel-level PR
curve) go to the flat design, which reads the rows as one stream over the
whole card, bins by a lookup grid and counts in per-lane-slot copies of the
histogram (counted also in ``flat_launch_count``); every other shape to the
binary-search histogram, a block per class tile and chunk of rows. On a CPU
tensor it runs :func:`binned_counter_update_plain`, the broadcast
compare-and-sum, which is also what the kernel is checked against on the
card. No switch sends a CUDA tensor to the plain version.

Both compare with float32 denormals flushed to zero, score and threshold
alike, as XLA's compares on the CPU and the TPU see them.

Under ``torch.func.vmap`` (a sliced Binned metric's per-row deltas, a
bootstrap's replicas) :func:`binned_counter_update` takes the lane route
(``_build.lane_route``): the lanes reach :func:`binned_counter_update_lanes`,
one launch of the kernel's lane-batched form on a CUDA tensor (counted in
``lanes_launch_count``; lanes of one row take its one-row kernel, lanes of
few classes and many rows the flat design by the same plan, counting all
lanes' rows at once, other lanes of many rows its one-pass kernel, which
needs no scratch while a class's histogram fits in a block's shared
memory), and the plain version with the lane axis
written out on a CPU tensor. The thresholds are one set for every lane:
batched thresholds raise. An unbatched call launches the kernel directly,
as before.
"""
import ctypes
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops.bucketed_rank import flush_denormals

Tensor = torch.Tensor

SOURCE = "binned_counters.cu"

# the kernel counts in int32 and rounds each count to float32 once, as the
# plain version rounds its int64 sums: bit-equal to it below 2^31 rows per
# call (or per lane), to the JAX package's float32 sums below 2^24 (D71)
MAX_ROWS = 1 << 31

# the lane-batched kernel's grid takes at most this many lanes a launch
MAX_LANES = 65535

# kernel launches since the last reset_launch_count(), read by chip_smoke.py:
# of the kernel, of its lane-batched form, and of either that ran the flat
# design (counted in one of the first two as well)
launch_count = 0
lanes_launch_count = 0
flat_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, lanes_launch_count, flat_launch_count
    launch_count = 0
    lanes_launch_count = 0
    flat_launch_count = 0


def binned_counter_update_plain(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain version: materialises the ``(N, C, T)`` comparison and sums
    it in int64, each count rounded to float32 once (past 2^24 rows the JAX
    package's kernel rounds at every tile instead, D71). ``target`` is 0/1
    (only ``== 1`` counts as positive). With a
    leading lane axis (``(B, N, C)`` inputs) it is the plain version of the
    lane-batched form: ``(B, C, T)`` counts, each lane's those of its rows."""
    tgt = (target == 1).unsqueeze(-1)
    # float32 denormals compare as zero, as XLA's compares on the CPU and the TPU see them
    ge = flush_denormals(preds.to(torch.float32)).unsqueeze(-1) >= flush_denormals(thresholds.to(torch.float32))
    tps = torch.sum(tgt & ge, dim=-3).to(torch.float32)
    fps = torch.sum((~tgt) & ge, dim=-3).to(torch.float32)
    fns = torch.sum(tgt & (~ge), dim=-3).to(torch.float32)
    return tps, fps, fns


binned_counter_update_lanes_plain = binned_counter_update_plain


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
    fn = lib.binned_counters_lanes_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.binned_counters_lanes_scratch.argtypes = [ctypes.c_int] * 4
    lib.binned_counters_lanes_scratch.restype = ctypes.c_longlong
    fn = lib.binned_counters_lanes_grid_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.binned_counters_flat_plan.argtypes = [ctypes.c_int] * 4
    lib.binned_counters_flat_plan.restype = ctypes.c_int
    return lib


def _count_flat(lib: ctypes.CDLL, lanes: int, n: int, c: int, t: int) -> None:
    """After a launch: count it in ``flat_launch_count`` too where the plan
    ran the flat design at this shape."""
    if lib.binned_counters_flat_plan(lanes, n, c, t) > 0:
        _build.count_launch(__name__, "flat_launch_count")


def _binned_counter_update_cuda(
    preds: Tensor, target: Tensor, thresholds: Tensor, order: Optional[Tuple[Tensor, Tensor]] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream."""
    n, c = preds.shape
    t = thresholds.shape[0]
    if n >= MAX_ROWS:
        raise ValueError(f"binned_counters takes fewer than 2^31 rows per call (int32 counters), got {n}")
    preds = preds.to(torch.float32).contiguous()
    tgt = _target_u8(target).contiguous()
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
        _count_flat(lib, 1, n, c, t)
    tps, fps, fns = out.unbind(0)
    return tps, fps, fns


def _target_u8(target: Tensor) -> Tensor:
    return target.view(torch.uint8) if target.dtype == torch.bool else (target == 1).to(torch.uint8)


def _binned_counter_lanes_cuda(
    preds: Tensor, target: Tensor, sorted_thr: Tensor, perm: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """The lane-batched kernel on PyTorch's current stream: one launch per
    ``MAX_LANES`` lanes (one launch at every shape the port's paths give)."""
    lanes, n, c = preds.shape
    t = sorted_thr.shape[0]
    if n >= MAX_ROWS:
        raise ValueError(f"binned_counters takes fewer than 2^31 rows per lane (int32 counters), got {n}")
    preds = preds.to(torch.float32).contiguous()
    tgt = _target_u8(target).contiguous()
    out = torch.empty((lanes, 3, c, t), dtype=torch.float32, device=preds.device)
    if not (c and t and lanes):
        out.zero_()
    else:
        lib = _library()
        sorted_thr, perm = sorted_thr.to(torch.float32).contiguous(), perm.to(torch.int32).contiguous()
        with torch.cuda.device(preds.device):
            stream = torch.cuda.current_stream(preds.device).cuda_stream
            for lo, hi in _build.lane_groups(lanes, 1, MAX_LANES):
                n_scratch = lib.binned_counters_lanes_scratch(hi - lo, n, c, t)
                scratch = torch.zeros((n_scratch,), dtype=torch.int32, device=preds.device) if n_scratch else None
                err = lib.binned_counters_lanes_launch(
                    preds[lo].data_ptr(), tgt[lo].data_ptr(), sorted_thr.data_ptr(), perm.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), out[lo].data_ptr(), hi - lo, n, c, t, stream,
                )
                if err != 0:
                    raise RuntimeError(f"binned_counters lanes kernel launch failed with cudaError {err}")
                _build.count_launch(__name__, "lanes_launch_count")
                _count_flat(lib, hi - lo, n, c, t)
    tps, fps, fns = out.unbind(1)
    return tps, fps, fns


def binned_counter_update_lanes(
    preds: Tensor, target: Tensor, thresholds: Tensor, order: Optional[Tuple[Tensor, Tensor]] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """The lane-batched form: ``preds`` and ``target`` ``(B, N, C)``, one
    ``(T,)`` threshold set; ``(tps, fps, fns)`` each ``(B, C, T)`` float32,
    lane ``b``'s equal to :func:`binned_counter_update` of its rows. On a
    CUDA tensor the kernel's lane-batched form; on a CPU tensor
    :func:`binned_counter_update_lanes_plain`."""
    if preds.device.type == "cpu":
        return binned_counter_update_lanes_plain(preds, target, thresholds)
    if preds.device.type == "cuda":
        sorted_thr, perm = threshold_order(thresholds) if order is None else order
        return _binned_counter_lanes_cuda(preds, target, sorted_thr, perm)
    raise ValueError(f"binned_counters runs on CPU or CUDA tensors, got device {preds.device}")


def _route_lanes(preds: Tensor, target: Tensor, thresholds: Tensor, sorted_thr: Tensor, perm: Tensor):
    return binned_counter_update_lanes(preds, target, thresholds, (sorted_thr, perm))


_ROUTE = _build.lane_route(
    "binned_counters",
    "(Tensor preds, Tensor target, Tensor thresholds, Tensor sorted_thr, Tensor perm) -> (Tensor, Tensor, Tensor)",
    lane_args=(0, 1), shared_args=(2, 3, 4), lanes_fn=_route_lanes,
)


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
        threshold, so it counts as a false negative. Under
        ``torch.func.vmap`` each lane is counted on its own, by the kernel's
        lane-batched form; the thresholds (and ``order``) must not be
        batched.
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
    if _build.batched(preds, target, thresholds, *(order or ())):
        sorted_thr, perm = threshold_order(thresholds) if order is None else order
        # (target == 1) as uint8: a dtype view has no batching rule in every torch release
        return _ROUTE(preds.to(torch.float32), (target == 1).to(torch.uint8), thresholds.to(torch.float32), sorted_thr, perm)
    if preds.device.type == "cpu":
        return binned_counter_update_plain(preds, target, thresholds)
    if preds.device.type == "cuda":
        return _binned_counter_update_cuda(preds, target, thresholds, order)
    raise ValueError(f"binned_counters runs on CPU or CUDA tensors, got device {preds.device}")
