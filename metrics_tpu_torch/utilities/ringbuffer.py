"""Capacity-bounded ``cat`` states (counterpart of
``metrics_tpu/utilities/ringbuffer.py``).

A :class:`CatBuffer` is a preallocated ``(capacity, *row)`` tensor with a
validity mask and a count of the rows that arrived after it was full. An
append writes at the fill level, in place, with no read back to the host;
rows past capacity are dropped and counted, never silently. The union of two buffers
(a sync across processes) is the concatenation of their data and masks.

Compute kernels read the buffer as ``(data, mask)`` and treat masked-out
rows as absent.
"""
from typing import Any, NamedTuple, Optional, Sequence

import torch

from metrics_tpu_torch.utilities.enums import DataType

Tensor = torch.Tensor


class CatBuffer(NamedTuple):
    """``data (cap, *row)``, ``mask (cap,)`` bool, and ``dropped``, an int32
    scalar counting the rows that did not fit."""

    data: Tensor
    mask: Tensor
    dropped: Tensor

    @classmethod
    def zeros(
        cls,
        capacity: int,
        row_shape: Sequence[int] = (),
        dtype: torch.dtype = torch.float32,
        device: Any = None,
    ) -> "CatBuffer":
        return cls(
            data=torch.zeros((capacity, *row_shape), dtype=dtype, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
            dropped=torch.zeros((), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def count(self) -> Tensor:
        """Number of valid rows, as a tensor on the buffer's device."""
        return self.mask.sum(dtype=torch.int32)

    def values(self) -> Tensor:
        """The valid rows (a boolean gather, which reads the count back)."""
        return self.data[self.mask]

    def __repr__(self) -> str:  # pragma: no cover
        return f"CatBuffer(capacity={self.capacity}, row_shape={tuple(self.data.shape[1:])}, dtype={self.data.dtype})"


def _put_rows(dst: Tensor, idx: Tensor, keep: Tensor, rows: Tensor) -> None:
    """Write ``rows[i]`` at ``dst[idx[i]]`` where ``keep[i]``, in place and
    without reading anything back to the host.

    A row not kept is written too, but to a slot whose final value it
    already holds: the first kept row's slot with that row's value, or,
    when no row is kept, slot 0 with its current value. Duplicate writes
    then carry equal values, and the result does not depend on their order.
    """
    rows = rows.to(dst.dtype)
    has = keep.any()
    # a (1,) index, not a 0-d one: indexing by a 0-d tensor reads it back
    first = torch.argmax(keep.to(torch.uint8)).reshape(1)
    fallback_slot = torch.where(has, idx.index_select(0, first)[0], 0)
    fallback_row = torch.where(has, rows.index_select(0, first)[0], dst[0])
    shape = (-1,) + (1,) * (rows.ndim - 1)
    dst.index_put_(
        (torch.where(keep, idx, fallback_slot),),
        torch.where(keep.reshape(shape), rows, fallback_row),
    )


def cat_append(buffer: CatBuffer, rows: Tensor, valid: Optional[Tensor] = None) -> CatBuffer:
    """Append ``rows`` (leading axis = batch) at the fill level.

    Rows past capacity are dropped and each adds one to ``dropped``.
    ``valid`` (bool ``(batch,)``) appends only the flagged rows, compacted:
    a rank can then contribute fewer rows than its block holds.

    The rows are written into ``buffer``'s ``data`` and ``mask`` in place,
    so an append does not copy the ring; the returned buffer shares them
    and carries the new ``dropped``.
    """
    rows = torch.as_tensor(rows, device=buffer.data.device)
    if tuple(rows.shape[1:]) != tuple(buffer.data.shape[1:]):
        raise ValueError(
            f"Row shape {tuple(rows.shape[1:])} does not match buffer row shape {tuple(buffer.data.shape[1:])}"
        )
    n = rows.shape[0]
    if n == 0:
        return buffer
    count = buffer.count().to(torch.int64)
    if valid is None:
        idx = count + torch.arange(n, device=rows.device)
        keep = idx < buffer.capacity
        n_new = torch.full((), n, dtype=torch.int64, device=rows.device)  # a fill, not a blocking copy
    else:
        valid = torch.as_tensor(valid, device=rows.device).to(torch.bool).reshape(-1)
        idx = count + torch.cumsum(valid, 0) - 1
        keep = valid & (idx < buffer.capacity)
        n_new = valid.sum()
    overflow = torch.clamp(count + n_new - buffer.capacity, min=0)
    if buffer.capacity:
        _put_rows(buffer.data, idx, keep, rows)
        _put_rows(buffer.mask, idx, keep, torch.ones(n, dtype=torch.bool, device=rows.device))
    return buffer._replace(dropped=buffer.dropped + overflow.to(torch.int32))


def cat_concat(a: CatBuffer, b: CatBuffer) -> CatBuffer:
    """Union of two buffers; the capacity grows to the sum."""
    return CatBuffer(
        data=torch.cat([a.data, b.data], dim=0),
        mask=torch.cat([a.mask, b.mask], dim=0),
        dropped=a.dropped + b.dropped,
    )


def init_score_ring_states(metric: Any, capacity: int, num_classes: Optional[int], pos_label: Optional[int] = None) -> DataType:
    """Register the ``(preds, target)`` ring pair of a score-based curve
    metric in capacity mode and return its data mode: binary, or one-vs-rest
    multiclass when ``num_classes > 1``. ``pos_label`` is fixed to 1."""
    if pos_label not in (None, 1):
        raise ValueError("`pos_label` other than 1 is not supported together with `capacity` mode")
    mode = DataType.MULTICLASS if num_classes and num_classes > 1 else DataType.BINARY
    row = (num_classes,) if mode == DataType.MULTICLASS else ()
    metric.add_state("preds", default=CatBuffer.zeros(capacity, row, torch.float32), dist_reduce_fx="cat")
    metric.add_state("target", default=CatBuffer.zeros(capacity, (), torch.int32), dist_reduce_fx="cat")
    return mode


def reject_valid_kwarg(valid: Optional[Tensor]) -> None:
    """``valid`` masks exist in capacity mode only."""
    if valid is not None:
        raise ValueError("`valid` masks are only supported in capacity (static-shape) mode")


def score_ring_update(metric: Any, preds: Tensor, target: Tensor, valid: Optional[Tensor], metric_name: str) -> None:
    """The capacity-mode update of the curve metrics: shape checks and a
    masked append to both rings."""
    if metric.mode == DataType.MULTICLASS and preds.ndim != 2:
        raise ValueError(f"capacity-mode multiclass {metric_name} expects (N, C) scores")
    if metric.mode == DataType.BINARY and preds.ndim != 1:
        raise ValueError(f"capacity-mode binary {metric_name} expects (N,) scores")
    metric.preds = cat_append(metric.preds, preds, valid)
    metric.target = cat_append(metric.target, target.to(torch.int32), valid)
