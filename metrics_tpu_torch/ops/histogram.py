"""Per-bucket counts of integer ids (counterpart of the histogram kernel in
``metrics_tpu/ops/pallas_kernels.py``, ``_histogram_kernel`` and
``histogram_pallas``).

On a CUDA tensor :func:`histogram` launches the hand-written Hopper kernel
``csrc/histogram.cu``, which replaces the TPU kernel; if it cannot, it
raises. On a CPU tensor it runs :func:`histogram_plain`, a scatter-add,
which is also what the kernel is checked against on the card. No switch
sends a CUDA tensor to the plain version, and there is no bucket ceiling:
the JAX package's 8192-bucket ``auto`` rule existed for the TPU's VMEM.

Under ``torch.func.vmap`` (a sliced confusion matrix's per-row deltas, a
bootstrap's replicas) :func:`histogram` takes the lane route
(``_build.lane_route``): the lanes' ids reach :func:`histogram_lanes`, one
launch of the kernel's lane-batched form on a CUDA tensor (each counted in
``lanes_launch_count``), and :func:`histogram_lanes_plain`, the scatter-add
with the lane axis written out, on a CPU tensor. An unbatched call launches
the kernel directly, as before.
"""
import ctypes

import torch

from metrics_tpu_torch.ops import _build

Tensor = torch.Tensor

SOURCE = "histogram.cu"

# kernel launches since the last reset_launch_count(), read by chip_smoke.py:
# of the kernel, and of its lane-batched form
launch_count = 0
lanes_launch_count = 0

# a lane-batched launch counts into bins lane * num_buckets + id, an index
# that stays below 2^31
_LANE_BINS_LIMIT = (1 << 31) - 1


def reset_launch_count() -> None:
    global launch_count, lanes_launch_count
    launch_count = 0
    lanes_launch_count = 0


def _ids(bucket_ids: Tensor) -> Tensor:
    if bucket_ids.dtype.is_floating_point or bucket_ids.dtype.is_complex or bucket_ids.dtype == torch.bool:
        raise TypeError(f"histogram counts integer ids, got {bucket_ids.dtype}")
    return bucket_ids.reshape(-1).to(torch.int32)


def histogram_plain(bucket_ids: Tensor, num_buckets: int) -> Tensor:
    """The plain version: ids outside ``[0, num_buckets)`` go to one extra
    bin, a scatter-add counts, and the extra bin is cut off."""
    ids = _ids(bucket_ids).to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_buckets), ids, num_buckets)
    out = torch.zeros(num_buckets + 1, dtype=torch.int32, device=ids.device)
    out.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    return out[:num_buckets]


def histogram_lanes_plain(ids: Tensor, num_buckets: int) -> Tensor:
    """The plain version of the lane-batched form: ``ids`` ``(B, n)``
    integer, counts ``(B, num_buckets)`` int32, each lane's row equal to
    :func:`histogram_plain` of its ids."""
    ids = ids.to(torch.int32).to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_buckets), ids, num_buckets)
    out = torch.zeros((ids.shape[0], num_buckets + 1), dtype=torch.int32, device=ids.device)
    out.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    return out[:, :num_buckets]


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.histogram_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.histogram_lanes_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _histogram_cuda(bucket_ids: Tensor, num_buckets: int) -> Tensor:
    """Launch the Hopper kernel on PyTorch's current stream."""
    ids = _ids(bucket_ids).contiguous()
    out = torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
    n = ids.shape[0]
    if n:
        fn = _library().histogram_launch
        with torch.cuda.device(ids.device):
            stream = torch.cuda.current_stream(ids.device).cuda_stream
            err = fn(ids.data_ptr(), n, num_buckets, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"histogram kernel launch failed with cudaError {err}")
        _build.count_launch(__name__)
    return out


def _histogram_lanes_cuda(ids: Tensor, num_buckets: int) -> Tensor:
    """The lane-batched kernel on PyTorch's current stream: one launch per
    run of lanes whose bins stay below 2^31 (one run at every shape the
    port's paths give it)."""
    ids = ids.to(torch.int32).contiguous()
    lanes, n = ids.shape
    out = torch.zeros((lanes, num_buckets), dtype=torch.int32, device=ids.device)
    if n and lanes:
        fn = _library().histogram_lanes_launch
        with torch.cuda.device(ids.device):
            stream = torch.cuda.current_stream(ids.device).cuda_stream
            for lo, hi in _build.lane_groups(lanes, num_buckets, _LANE_BINS_LIMIT):
                err = fn(ids[lo].data_ptr(), hi - lo, n, num_buckets, out[lo].data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"histogram lanes kernel launch failed with cudaError {err}")
                _build.count_launch(__name__, "lanes_launch_count")
    return out


def histogram_lanes(ids: Tensor, num_buckets: int) -> Tensor:
    """The lane-batched form: ``ids`` ``(B, n)`` integer, counts ``(B,
    num_buckets)`` int32, each lane counted as :func:`histogram` counts it.
    On a CUDA tensor the kernel's lane-batched form; on a CPU tensor
    :func:`histogram_lanes_plain`."""
    if ids.device.type == "cpu":
        return histogram_lanes_plain(ids, num_buckets)
    if ids.device.type == "cuda":
        return _histogram_lanes_cuda(ids, num_buckets)
    raise ValueError(f"histogram runs on CPU or CUDA tensors, got device {ids.device}")


_ROUTE = _build.lane_route(
    "histogram", "(Tensor ids, int num_buckets) -> Tensor", lane_args=(0,), shared_args=(), lanes_fn=histogram_lanes
)


def histogram(bucket_ids: Tensor, num_buckets: int) -> Tensor:
    """int32 counts of ``bucket_ids`` over ``[0, num_buckets)``.

    Ids outside that range, negatives included, are not counted; no ids
    give zeros. Integer ids of any width are read as int32. Under
    ``torch.func.vmap`` each lane is counted on its own, by the kernel's
    lane-batched form.
    """
    num_buckets = int(num_buckets)
    if num_buckets < 1 or num_buckets >= 1 << 31:
        raise ValueError(f"histogram needs 1 <= num_buckets < 2^31, got {num_buckets}")
    if _build.batched(bucket_ids):
        return _ROUTE(_ids(bucket_ids), num_buckets)
    if bucket_ids.device.type == "cpu":
        return histogram_plain(bucket_ids, num_buckets)
    if bucket_ids.device.type == "cuda":
        return _histogram_cuda(bucket_ids, num_buckets)
    raise ValueError(f"histogram runs on CPU or CUDA tensors, got device {bucket_ids.device}")
