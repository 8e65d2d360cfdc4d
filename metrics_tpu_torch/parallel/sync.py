"""Gathering states across processes (counterpart of
``metrics_tpu/parallel/sync.py``; the process-level regime only).

The transport is ``torch.distributed``: NCCL between cards, Gloo in the CPU
tests and between processes that share one card. A gather that fails
raises; nothing here degrades to a rank's local data.

Not in this module yet: ``fused_sync`` (one reduction per dtype bucket),
``RetryingGather`` with its retry and health records, and the quantized and
chunked transports.
"""
from typing import List, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def distributed_available() -> bool:
    """``torch.distributed`` is initialised and its world is larger than one
    process."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _all_gather(tensor: Tensor, group: Optional[dist.ProcessGroup]) -> List[Tensor]:
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return parts


def _pad_gather_trim(tensor: Tensor, group: Optional[dist.ProcessGroup] = None) -> List[Tensor]:
    """The ragged gather: gather every rank's shape, pad to the elementwise
    largest, gather the payload, trim each rank's part back to its shape.

    Every rank must give a tensor of the same dtype and number of
    dimensions. A 0-d tensor has no shape to agree and is gathered at once.
    """
    if tensor.ndim == 0:
        return _all_gather(tensor, group)
    local_shape = torch.tensor(tensor.shape, dtype=torch.int64, device=tensor.device)
    shapes = torch.stack(_all_gather(local_shape, group)).tolist()
    max_shape = [max(dims) for dims in zip(*shapes)]
    if list(tensor.shape) == max_shape:
        padded = tensor
    else:
        padded = tensor.new_zeros(max_shape)
        padded[tuple(slice(0, d) for d in tensor.shape)] = tensor
    gathered = _all_gather(padded, group)
    return [part[tuple(slice(0, d) for d in shape)] for part, shape in zip(gathered, shapes)]


def gather_all_arrays(tensor: Tensor, group: Optional[dist.ProcessGroup] = None) -> List[Tensor]:
    """Every process's ``tensor``, in rank order, allowing leading (and
    other) dimensions that differ between ranks. In a world of one process
    it is ``[tensor]``."""
    if not distributed_available():
        return [tensor]
    return _pad_gather_trim(tensor, group)
