"""Syncing metric states across processes (counterpart of
``metrics_tpu/parallel/sync.py``; the process-level regime, exact
transport).

The transport is ``torch.distributed``: NCCL between cards, Gloo in the CPU
tests and between processes that share one card. :func:`fused_sync` syncs
the states of many metrics with one ``all_reduce`` per (reduction, dtype)
bucket; only ``cat`` states (lists, ``CatBuffer`` rings) are gathered. A
collective that fails raises; nothing here degrades to a rank's local data.

Every collective goes through a communicator: ``torch.distributed`` itself,
or an object with its ``all_reduce``, ``all_gather``, ``get_world_size``
and ``get_rank`` (``Metric(dist_sync_fn=...)``, a fake world in tests).

Not in this module yet: ``RetryingGather`` with its retry and health
records, and the quantized and chunked transports.
"""
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.utilities.data import _tensor_leaves
from metrics_tpu_torch.utilities.guard import FaultCounters
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer

Tensor = torch.Tensor
Reduction = Union[str, Callable, None]

# the dtypes a ragged gather can carry, by the code its header sends
_DTYPES = (
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
)
_MAX_DIMS = 8
_BUCKETED = ("sum", "mean", "max", "min")


def distributed_available() -> bool:
    """``torch.distributed`` is initialised and its world is larger than one
    process."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _all_gather(tensor: Tensor, group: Optional[Any], comm: Any) -> List[Tensor]:
    parts = [torch.empty_like(tensor) for _ in range(comm.get_world_size(group))]
    comm.all_gather(parts, tensor.contiguous(), group=group)
    return parts


def _pad_gather_trim(tensor: Tensor, group: Optional[Any] = None, comm: Any = dist) -> List[Tensor]:
    """The ragged gather: gather every rank's header (number of dimensions,
    dtype, shape), pad to the elementwise largest shape, gather the
    payload, trim each rank's part back to its shape.

    A rank whose tensor is empty takes the number of dimensions and the
    dtype of the ranks that hold rows, so a rank without a batch never
    sends a payload of another size. Ranks that hold rows and disagree
    raise on every rank, before any payload is sent.
    """
    if tensor.ndim > _MAX_DIMS or tensor.dtype not in _DTYPES:
        raise ValueError(f"cannot gather a {tensor.ndim}-d {tensor.dtype} tensor")
    header = torch.full((2 + _MAX_DIMS,), -1, dtype=torch.int64)
    header[0], header[1] = tensor.ndim, _DTYPES.index(tensor.dtype)
    header[2:2 + tensor.ndim] = torch.tensor(tensor.shape, dtype=torch.int64)
    headers = torch.stack(_all_gather(header.to(tensor.device), group, comm)).tolist()
    shapes = [h[2:2 + h[0]] for h in headers]
    full = [h for h, s in zip(headers, shapes) if all(d > 0 for d in s)]
    ref = full[0] if full else headers[0]
    if any(h[:2] != ref[:2] for h in full):
        raise ValueError(
            "ranks gather tensors of different dtypes or numbers of dimensions: "
            + ", ".join(f"rank {r}: {_DTYPES[h[1]]} {s}" for r, (h, s) in enumerate(zip(headers, shapes)))
        )
    ndim, dtype = ref[0], _DTYPES[ref[1]]
    # an empty rank of another form stands for zero rows of the widest row
    adapted = [h[:2] != ref[:2] for h in headers]
    shapes = [[0] * ndim if a else s for a, s in zip(adapted, shapes)]
    max_shape = [max(dims) for dims in zip(*shapes)] if ndim else []
    shapes = [[0] + max_shape[1:] if a else s for a, s in zip(adapted, shapes)]
    if tensor.dtype != dtype or tensor.ndim != ndim:
        tensor = torch.zeros([0] * ndim, dtype=dtype, device=tensor.device)
    if list(tensor.shape) == max_shape:
        padded = tensor
    else:
        padded = tensor.new_zeros(max_shape)
        padded[tuple(slice(0, d) for d in tensor.shape)] = tensor
    gathered = _all_gather(padded, group, comm)
    return [part[tuple(slice(0, d) for d in shape)] for part, shape in zip(gathered, shapes)]


def gather_all_arrays(tensor: Tensor, group: Optional[dist.ProcessGroup] = None) -> List[Tensor]:
    """Every process's ``tensor``, in rank order, allowing leading (and
    other) dimensions that differ between ranks. In a world of one process
    it is ``[tensor]``."""
    if not distributed_available():
        return [tensor]
    return _pad_gather_trim(tensor, group)


_REDUCE_OPS = {"sum": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN"}


def _is_sketch_state(value: Any) -> bool:
    """Mergeable sketch states (``streaming/sketches.py``), recognised by
    their class marker, so this module never imports the sketches."""
    return getattr(type(value), "is_sketch_state", False)


def _list_local(value: list, template: Optional[Tensor], state: Dict[str, Any]) -> Tensor:
    """A list state's rows as one tensor in its template's dtype; an empty
    list sends the template (a ``(0, *row)`` tensor) itself, or without one
    an empty float32 tensor on the device of the state's other tensors."""
    if value:
        local = torch.cat([torch.atleast_1d(v) for v in value])
        return local if template is None else local.to(template.dtype)
    if template is not None:
        return template
    device = next((t.device for v in state.values() for t in _tensor_leaves(v)), torch.device("cpu"))
    return torch.zeros((0,), dtype=torch.float32, device=device)


def _gathered_value(value: Tensor, fx: Reduction, gather: Callable[[Tensor], List[Tensor]]) -> Any:
    """A tensor state outside the buckets: gathered, then concatenated
    (``cat``), stacked (None) or reduced by a callable."""
    parts = gather(value)
    if fx == "cat":
        return torch.cat([torch.atleast_1d(p) for p in parts])
    stacked = torch.stack(parts)
    if fx is None:
        return stacked
    if callable(fx):
        return fx(stacked)
    raise ValueError(f"Unsupported dist_reduce_fx: {fx!r}")


def sync_cat_buffer(buffer: CatBuffer, gather: Callable[[Tensor], List[Tensor]], dropped: Tensor) -> CatBuffer:
    """The union of every rank's ring: ``data`` and ``mask`` gathered and
    stacked along the capacity (masked rows stay masked), with ``dropped``,
    the ranks' summed drop count."""
    data = torch.cat(gather(buffer.data))
    mask = torch.cat(gather(buffer.mask))
    return CatBuffer(data, mask, dropped.reshape(()))


def fused_sync(
    states: Sequence[Dict[str, Any]],
    reductions: Sequence[Dict[str, Reduction]],
    group: Optional[Any] = None,
    defaults: Optional[Sequence[Dict[str, Any]]] = None,
    comm: Optional[Any] = None,
    same_as: Optional[Sequence[Optional[int]]] = None,
) -> List[Dict[str, Any]]:
    """Sync many metrics' states with one collective per (reduction, dtype).

    Every sum, mean, max and min tensor of every metric is raveled into one
    flat vector per (reduction, dtype), reduced with one ``all_reduce`` and
    scattered back (a mean bucket is a sum divided by the world size). The
    same buckets carry:

    - the fault counters (:class:`FaultCounters`, int64), in the int64 sum
      bucket;
    - sketch states with an elementwise merge: CountMin counters in the
      sum bucket, HyperLogLog registers in the max bucket;
    - every quantile sketch of the collection, packed into one float32
      payload: each rank writes its payload into zeros at its own offset,
      the payload joins the float32 sum bucket (so the sum is a gather),
      and each rank unpacks every rank's sketch and folds them with
      ``sketch_merge`` in rank order. The sum turns a ``-0.0`` item into
      ``+0.0``, as the JAX package's ``psum`` does;
    - the ``dropped`` counts of ``CatBuffer`` rings, in their sum bucket.

    List states and rings' ``data`` and ``mask`` are gathered (two
    ``all_gather`` each: the header, then the payload). A list state is
    gathered in its template's dtype (``defaults[i][name]``, a
    ``(0, *row)`` tensor), which an empty rank sends in its place; it
    syncs to the list of the ranks' non-empty parts. The states given are
    left as they are; new tensors are returned.

    ``comm`` replaces ``torch.distributed`` as the communicator (see the
    module's docstring).

    ``same_as[i] = j`` says that metric ``i`` holds the same tensors as
    metric ``j`` on this rank (a compute group of a collection). Every rank
    must send the same collectives, and groups form from each rank's own
    data, so the buckets always carry every metric; a gathered state of
    ``i`` is taken from ``j`` only when every rank says so. The ranks vote
    in the int64 max bucket, before any gather.
    """
    comm = dist if comm is None else comm
    world, rank = comm.get_world_size(group), comm.get_rank(group)

    def gather(tensor: Tensor) -> List[Tensor]:
        return _pad_gather_trim(tensor, group, comm)

    buckets: Dict[Tuple[str, torch.dtype], List[Tuple[Any, Tensor]]] = {}
    gather_merge: List[Tuple[int, str, Any]] = []
    passthrough: List[Tuple[int, str, Any, Reduction]] = []
    out: List[Dict[str, Any]] = [dict(s) for s in states]

    def bucket(fx: str, leaf: Tensor, slot: Any) -> None:
        buckets.setdefault((fx, leaf.dtype), []).append((slot, leaf))

    for i, (state, reds) in enumerate(zip(states, reductions)):
        for name, value in state.items():
            fx = reds[name]
            if isinstance(value, FaultCounters):
                bucket("sum", value.counts, (i, name, FaultCounters))
            elif _is_sketch_state(value):
                er = value.elementwise_reduction
                if er is not None:  # elementwise sketches are single-tensor
                    bucket(er, value[0], (i, name, type(value)))
                else:
                    gather_merge.append((i, name, value))
            elif isinstance(value, CatBuffer):
                bucket("sum", value.dropped.reshape(1), (i, name, "dropped"))
                passthrough.append((i, name, value, fx))
            elif fx in _BUCKETED and isinstance(value, Tensor):
                bucket(fx, value, (i, name, None))
            else:
                passthrough.append((i, name, value, fx))

    n_metrics = len(states)
    if same_as is not None and passthrough:
        # each rank's vote, and its negation: the max of both says whether
        # every rank gave the same index
        alias = torch.tensor([i if j is None else j for i, j in enumerate(same_as)], dtype=torch.int64)
        device = next((t.device for st in states for v in st.values() for t in _tensor_leaves(v)), torch.device("cpu"))
        bucket("max", torch.cat([alias, -alias]).to(device), "vote")

    if gather_merge:
        payload = torch.cat([v.pack() for (_, _, v) in gather_merge])
        wide = payload.new_zeros((world * payload.shape[0],))
        wide[rank * payload.shape[0]:(rank + 1) * payload.shape[0]] = payload
        bucket("sum", wide, "sketches")

    dropped: Dict[Tuple[int, str], Tensor] = {}
    per_rank: Optional[Tensor] = None
    votes: Optional[List[int]] = None
    for (fx, _dtype), leaves in buckets.items():
        synced = torch.cat([v.reshape(-1) for (_, v) in leaves])
        comm.all_reduce(synced, op=getattr(dist.ReduceOp, _REDUCE_OPS[fx]), group=group)
        if fx == "mean":
            synced = (synced / world).to(synced.dtype)
        offset = 0
        for slot, v in leaves:
            leaf = synced[offset:offset + v.numel()].reshape(v.shape)
            offset += v.numel()
            if slot == "sketches":
                per_rank = leaf.reshape(-1, payload.shape[0])
                continue
            if slot == "vote":
                votes = leaf.tolist()
                continue
            i, name, kind = slot
            if kind == "dropped":
                dropped[(i, name)] = leaf
            elif kind is None:
                out[i][name] = leaf
            else:  # FaultCounters or an elementwise sketch
                out[i][name] = kind(leaf)

    offset = 0
    for (i, name, v) in gather_merge:
        size = v.packed_size
        merged = None
        for part in per_rank:
            s = type(v).unpack_like(part[offset:offset + size], v)
            merged = s if merged is None else merged.sketch_merge(s)
        out[i][name] = merged
        offset += size

    # a metric that every rank says holds another's tensors takes that
    # metric's gathered states
    shared = {}
    if votes is not None:
        shared = {i: votes[i] for i in range(n_metrics) if votes[i] != i and votes[i] == -votes[n_metrics + i]}
    for (i, name, value, fx) in passthrough:
        if i in shared:
            continue
        if isinstance(value, CatBuffer):
            out[i][name] = sync_cat_buffer(value, gather, dropped[(i, name)])
        elif isinstance(value, list):
            template = defaults[i].get(name) if defaults is not None else None
            local = _list_local(value, template, states[i])
            out[i][name] = [t for t in gather(local) if t.shape[0]]
        else:
            out[i][name] = _gathered_value(value, fx, gather)
    for (i, name, _, _) in passthrough:
        if i in shared:
            out[i][name] = out[shared[i]][name]
    return out
