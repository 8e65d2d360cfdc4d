"""Per-bucket counts of integer ids (counterpart of the histogram kernel in
``metrics_tpu/ops/pallas_kernels.py``, ``_histogram_kernel`` and
``histogram_pallas``).

On a CUDA tensor :func:`histogram` launches the hand-written Hopper kernel
``csrc/histogram.cu``, which replaces the TPU kernel; if it cannot, it
raises. On a CPU tensor it runs :func:`histogram_plain`, a scatter-add,
which is also what the kernel is checked against on the card. No switch
sends a CUDA tensor to the plain version, and there is no bucket ceiling:
the JAX package's 8192-bucket ``auto`` rule existed for the TPU's VMEM.
"""
import ctypes

import torch

from metrics_tpu_torch.ops import _build

Tensor = torch.Tensor

SOURCE = "histogram.cu"

# kernel launches since the last reset_launch_count(); read by chip_smoke.py
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


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


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.histogram_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _histogram_cuda(bucket_ids: Tensor, num_buckets: int) -> Tensor:
    """Launch the Hopper kernel on PyTorch's current stream."""
    _build.refuse_batched("K2 (ops/histogram.py)", bucket_ids)
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


def histogram(bucket_ids: Tensor, num_buckets: int) -> Tensor:
    """int32 counts of ``bucket_ids`` over ``[0, num_buckets)``.

    Ids outside that range, negatives included, are not counted; no ids
    give zeros. Integer ids of any width are read as int32.
    """
    num_buckets = int(num_buckets)
    if num_buckets < 1 or num_buckets >= 1 << 31:
        raise ValueError(f"histogram needs 1 <= num_buckets < 2^31, got {num_buckets}")
    if bucket_ids.device.type == "cpu":
        return histogram_plain(bucket_ids, num_buckets)
    if bucket_ids.device.type == "cuda":
        return _histogram_cuda(bucket_ids, num_buckets)
    raise ValueError(f"histogram runs on CPU or CUDA tensors, got device {bucket_ids.device}")
