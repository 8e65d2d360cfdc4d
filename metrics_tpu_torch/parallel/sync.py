"""Syncing metric states across processes (counterpart of
``metrics_tpu/parallel/sync.py``; the process-level regime).

The transport is ``torch.distributed``: NCCL between cards, Gloo in the CPU
tests and between processes that share one card. :func:`fused_sync` syncs
the states of many metrics with one ``all_reduce`` per (reduction, dtype)
bucket; only ``cat`` states (lists, ``CatBuffer`` rings) are gathered.

Every collective goes through a communicator: an object with
``torch.distributed``'s ``all_reduce``, ``all_gather``, ``get_world_size``
and ``get_rank`` (``Metric(dist_sync_fn=...)``, a fake world in tests). By
default it is :class:`RetryingGather` around ``torch.distributed``: each
collective is bounded by a timeout and a circuit breaker, and one that
cannot complete degrades loudly: it records a ``gather_degraded`` health
event, warns, and the whole sync then takes this rank's own state, the
value of a world of one process (a mean is not divided by the world size,
the zeros at the other ranks' offsets are never unpacked as sketches, a
ring keeps its own ``dropped``). A wedged peer costs ``timeout_s``, never a
hang. ``RetryingGather(fallback_local=False)`` raises instead.

The wire: a collective's tensor travels in its own dtype, except where the
backends carry no such dtype (``int16``: neither Gloo nor NCCL) and the
quantized wires (``ops/quantize.py``), which travel as bytes (``uint8``).
Each lane of such a wire has one writer, so the bytes arrive exactly.

Transports of ``fused_sync`` (``transport=``): ``exact`` (the default),
``int8`` and ``fp16``; a quantized transport carries the float sum leaves
and the quantile payloads as one wire, gathered once (``all_gather``, where
the JAX package scatters into zeros and ``psum``-s: the same bits). The
chunked schedule (``chunks=``) splits each bucket into per-chunk
``all_reduce`` calls, issued in order on a thread while the caller scatters
the finished chunks back; the values are bit-equal to one collective.

Every sequence of collectives runs under :data:`gather_sequence_lock`:
collectives pair across processes by issue order, so two sequences on two
threads of one process (a blocking ``compute()`` and an overlapped cycle)
serialize and never interleave.
"""
import contextlib
import functools
import queue
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.analysis.lockwitness import named_lock, note_blocking
from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce
from metrics_tpu_torch.ops.quantize import (
    WireCodec,
    as_bytes,
    decode_leaf,
    encode_leaf,
    from_bytes,
    quantizes_on_host,
    resolve_codec,
)
from metrics_tpu_torch.parallel.retry import CircuitOpenError, RetryBudgetExceededError, RetryPolicy
from metrics_tpu_torch.utilities.data import _tensor_leaves
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utilities.guard import FaultCounters
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer

Tensor = torch.Tensor
Reduction = Union[str, Callable, None]

# the dtypes a ragged gather can carry, by the code its header sends
_DTYPES = (
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
)
# dtypes that neither Gloo nor NCCL carries: they travel as bytes
_AS_BYTES = (torch.int16,)
_MAX_DIMS = 8
_BUCKETED = ("sum", "mean", "max", "min")

# Serializes whole sequences of collectives within a process (re-entrant: a
# sequence may nest helpers that take it again).
# not hot: blocking under it is its job (the JAX package's LOCK_ORDER.md)
gather_sequence_lock = named_lock("gather_sequence_lock", threading.RLock(), hot=False)


def distributed_available() -> bool:
    """``torch.distributed`` is initialised and its world is larger than one
    process."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


# --------------------------------------------------------------------------
# degradation: the marker a communicator returns, and a world of one
# --------------------------------------------------------------------------


class _Degraded:
    def __repr__(self) -> str:
        return "DEGRADED"


#: What a communicator's ``all_reduce``/``all_gather`` returns when the
#: collective fell back to this rank's own data (``RetryingGather``).
DEGRADED = _Degraded()


class _LocalOnly(Exception):
    """A collective of the sequence degraded: the sync takes the local value."""


class _WorldOfOne:
    """A world of one process: the communicator of a degraded sync."""

    def get_world_size(self, group: Any = None) -> int:
        return 1

    def get_rank(self, group: Any = None) -> int:
        return 0

    def all_reduce(self, tensor: Tensor, op: Any = None, group: Any = None) -> None:
        return None

    def all_gather(self, parts: List[Tensor], tensor: Tensor, group: Any = None) -> None:
        parts[0].copy_(tensor)


_WORLD_OF_ONE = _WorldOfOne()


def _count_payload(tensor: Tensor) -> None:
    """The bytes this process ships into one collective's payload, in the
    ``sync_payload_bytes`` self-telemetry counter (a quantized wire counts
    its encoded bytes; the small shape headers are not counted)."""
    from metrics_tpu_torch.obs.runtime_metrics import registry as _obs_registry

    _obs_registry.counter("sync_payload_bytes").inc(int(tensor.numel()) * tensor.element_size())


def _all_reduce(comm: Any, tensor: Tensor, op: str, group: Any) -> None:
    _count_payload(tensor)
    if comm.all_reduce(tensor, op=getattr(dist.ReduceOp, op), group=group) is DEGRADED:
        raise _LocalOnly


def _all_gather(tensor: Tensor, group: Optional[Any], comm: Any, payload: bool = True) -> List[Tensor]:
    tensor = tensor.contiguous()
    wire = as_bytes(tensor) if tensor.dtype in _AS_BYTES else tensor
    if payload:
        _count_payload(wire)
    parts = [torch.empty_like(wire) for _ in range(comm.get_world_size(group))]
    if comm.all_gather(parts, wire, group=group) is DEGRADED:
        raise _LocalOnly
    if wire is tensor:
        return parts
    return [from_bytes(p, tensor.dtype).reshape(tensor.shape) for p in parts]


def _pad_gather_trim(tensor: Tensor, group: Optional[Any] = None, comm: Any = dist) -> List[Tensor]:
    """The ragged gather: gather every rank's header (number of dimensions,
    dtype, shape), pad to the elementwise largest shape, gather the
    payload, trim each rank's part back to its shape.

    A rank whose tensor is empty takes the number of dimensions and the
    dtype of the ranks that hold rows, so a rank without a batch never
    sends a payload of another size. Ranks that hold rows and disagree
    raise on every rank, before any payload is sent. When the header or
    the payload degrades (see :class:`RetryingGather`) the pair no longer
    describes every rank, so it raises ``_LocalOnly`` and the caller keeps
    this rank's own rows.
    """
    if tensor.ndim > _MAX_DIMS or tensor.dtype not in _DTYPES:
        raise ValueError(f"cannot gather a {tensor.ndim}-d {tensor.dtype} tensor")
    header = torch.full((2 + _MAX_DIMS,), -1, dtype=torch.int64)
    header[0], header[1] = tensor.ndim, _DTYPES.index(tensor.dtype)
    header[2:2 + tensor.ndim] = torch.tensor(tensor.shape, dtype=torch.int64)
    headers = torch.stack(_all_gather(header.to(tensor.device), group, comm, payload=False)).tolist()
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


# --------------------------------------------------------------------------
# the bounded transport
# --------------------------------------------------------------------------


class GatherTimeoutError(RuntimeError):
    """A collective did not complete within its timeout."""


@contextlib.contextmanager
def _on_stream(stream: Optional[Any]):
    """Run on ``stream`` (a CUDA stream of the caller's thread), or as it is
    for CPU tensors."""
    if stream is None:
        yield
    else:
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            yield


def _caller_stream(tensor: Tensor) -> Optional[Any]:
    return torch.cuda.current_stream(tensor.device) if tensor.is_cuda else None


def _complete(work: Any, stream: Optional[Any]) -> None:
    """Wait until a collective has completed, on the host: NCCL returns once
    the collective is enqueued, so a timeout around the call alone would
    bound nothing."""
    if work is not None and hasattr(work, "wait"):
        work.wait()
    if stream is not None:
        stream.synchronize()


class RetryingGather:
    """A communicator that bounds each collective of ``comm`` (default
    ``torch.distributed``) by a timeout, retries a collective that raised
    with exponential backoff, and degrades to this rank's own data when the
    budget is spent, instead of hanging on a wedged peer.

    Each collective runs on a daemon thread and includes its completion
    (``async_op=True`` and ``work.wait()``, then a synchronize of the
    caller's CUDA stream), so the bound holds under NCCL too, whose calls
    return once enqueued. An ``all_reduce`` works on a copy and writes the
    result back only when the collective completed; an ``all_gather`` that
    degraded leaves its output list undefined.

    When a call has used its budget it records one ``gather_degraded``
    health event, warns, and returns :data:`DEGRADED`; with
    ``fallback_local=False`` it raises instead. The breaker then opens for
    ``cooldown_s``: every call in that time returns :data:`DEGRADED` at
    once, without an event. A timed-out collective is never issued again,
    and after a timeout nothing more is issued on ``comm``: the collective
    may still complete on a slow peer and would pair with the next one, and
    an NCCL communicator cannot be used again after a timed-out collective.
    Such a transport stays degraded until the process group is built anew
    and a new ``RetryingGather`` installed (:func:`set_gather_transport`).
    A collective that raised closes the breaker again on a success after
    the cooldown. Same defaults as the JAX package: 120 s, 2 retries, 1 s
    backoff, 60 s cooldown, ``fallback_local=True``.
    """

    def __init__(
        self,
        comm: Any = None,
        timeout_s: float = 120.0,
        max_retries: int = 2,
        backoff_s: float = 1.0,
        fallback_local: bool = True,
        cooldown_s: float = 60.0,
    ) -> None:
        self.comm = dist if comm is None else comm
        self.fallback_local = fallback_local
        self.timed_out = False
        self._policy = RetryPolicy(
            timeout_s=timeout_s,
            max_retries=max_retries,
            backoff_s=backoff_s,
            cooldown_s=cooldown_s,
            retry_timeouts=False,
            timeout_error=GatherTimeoutError,
            name="collective",
            thread_name="metrics-tpu-gather",
        )

    @property
    def timeout_s(self) -> float:
        return self._policy.timeout_s

    @property
    def cooldown_s(self) -> float:
        return self._policy.cooldown_s

    def get_world_size(self, group: Any = None) -> int:
        return self.comm.get_world_size(group)

    def get_rank(self, group: Any = None) -> int:
        return self.comm.get_rank(group)

    def all_reduce(self, tensor: Tensor, op: Any = dist.ReduceOp.SUM, group: Any = None) -> Any:
        stream = _caller_stream(tensor)

        def run() -> Tensor:
            with _on_stream(stream):
                buf = tensor.clone()
                _complete(self._issue("all_reduce", buf, op=op, group=group), stream)
                return buf

        out = self._call(run)
        if out is DEGRADED:
            return DEGRADED
        tensor.copy_(out)
        return None

    def all_gather(self, parts: List[Tensor], tensor: Tensor, group: Any = None) -> Any:
        stream = _caller_stream(tensor)

        def run() -> None:
            with _on_stream(stream):
                _complete(self._issue("all_gather", parts, tensor, group=group), stream)

        return DEGRADED if self._call(run) is DEGRADED else None

    def reduce_scatter(self, output: Tensor, inputs: List[Tensor], op: Any = dist.ReduceOp.SUM, group: Any = None) -> Any:
        """``torch.distributed.reduce_scatter``, bounded like the others:
        ``output`` is written only when the collective completed."""
        stream = _caller_stream(output)

        def run() -> Tensor:
            with _on_stream(stream):
                buf = torch.empty_like(output)
                _complete(self._issue("reduce_scatter", buf, list(inputs), op=op, group=group), stream)
                return buf

        out = self._call(run)
        if out is DEGRADED:
            return DEGRADED
        output.copy_(out)
        return None

    def _issue(self, name: str, *args: Any, **kwargs: Any) -> Any:
        if self.comm is dist:
            kwargs["async_op"] = True
        return getattr(self.comm, name)(*args, **kwargs)

    def _call(self, fn: Callable[[], Any]) -> Any:
        if self.timed_out:
            return self._refuse("a collective timed out earlier; nothing more is issued on this communicator")
        try:
            return self._policy.call(fn)
        except CircuitOpenError as err:
            return self._refuse(f"circuit open for {err.retry_in_s:.0f}s more after repeated failures")
        except RetryBudgetExceededError as err:
            exhausted = err
        from metrics_tpu_torch.resilience.health import record_degradation

        self.timed_out = isinstance(exhausted.cause, GatherTimeoutError)
        record_degradation(
            "gather_degraded",
            f"collective failed after {exhausted.attempts} attempt(s): {exhausted.cause}",
            timeout_s=self.timeout_s,
            cooldown_s=self.cooldown_s,
            fallback_local=self.fallback_local,
            timed_out=self.timed_out,
        )
        if not self.fallback_local:
            raise exhausted.cause
        warnings.warn(
            f"collective FAILED after {exhausted.attempts} attempt(s) ({exhausted.cause}); degrading to "
            "LOCAL-ONLY state: synced values on this process cover this process's stream only, NOT the "
            "global one. Investigate the world before trusting aggregate metrics.",
            UserWarning,
        )
        return DEGRADED

    def _refuse(self, why: str) -> Any:
        if not self.fallback_local:
            raise GatherTimeoutError(f"collective refused: {why}")
        return DEGRADED


_DEFAULT_TRANSPORT: Optional[Any] = None


def _default_transport() -> Any:
    global _DEFAULT_TRANSPORT
    if _DEFAULT_TRANSPORT is None:
        _DEFAULT_TRANSPORT = RetryingGather(dist)
    return _DEFAULT_TRANSPORT


def set_gather_transport(transport: Optional[Any]) -> Optional[Any]:
    """Swap the default communicator of every sync (``None`` restores a
    :class:`RetryingGather` around ``torch.distributed``); returns the
    previous one."""
    global _DEFAULT_TRANSPORT
    prev = _DEFAULT_TRANSPORT
    _DEFAULT_TRANSPORT = transport
    return prev


def gather_all_arrays(tensor: Tensor, group: Optional[Any] = None, comm: Optional[Any] = None) -> List[Tensor]:
    """Every process's ``tensor``, in rank order, allowing leading (and
    other) dimensions that differ between ranks. In a world of one process,
    or when the gather degrades, it is ``[tensor]``."""
    if comm is None and not distributed_available():
        return [tensor]
    with gather_sequence_lock:
        try:
            return _pad_gather_trim(tensor, group, _default_transport() if comm is None else comm)
        except _LocalOnly:
            return [tensor]


# --------------------------------------------------------------------------
# the chunked schedule
# --------------------------------------------------------------------------

# Below this bucket size the chunk count from the environment keeps one
# collective: a few hundred bytes in k pieces pay k latencies to overlap
# nothing. An explicit ``chunks=`` has no floor.
SYNC_CHUNK_MIN_BYTES = 1 << 14

_chunks_warn_once = WarnOnce()


def _parse_sync_chunks(raw: str) -> Optional[int]:
    try:
        n = int(raw)
        if n < 1:
            raise ValueError
        return n
    except ValueError:
        _chunks_warn_once(
            ("sync-chunks", raw),
            f"METRICS_TPU_SYNC_CHUNKS={raw!r} is not a positive integer; keeping the single-collective fused_sync schedule.",
        )
        return None


_ENV_SYNC_CHUNKS = EnvParse("METRICS_TPU_SYNC_CHUNKS", _parse_sync_chunks, None)


def resolve_sync_chunks(programmatic: Optional[int] = None) -> int:
    """The chunk count: the argument, else ``METRICS_TPU_SYNC_CHUNKS``, else
    1. A malformed variable warns once and gives 1; a bad argument raises."""
    if programmatic is not None:
        if not isinstance(programmatic, int) or isinstance(programmatic, bool) or programmatic < 1:
            raise MetricsTPUUserError(f"sync chunk count must be a positive integer, got {programmatic!r}")
        return programmatic
    value = _ENV_SYNC_CHUNKS()
    return 1 if value is None else value


def reset_sync_chunks_env_state() -> None:
    """Forget the memoized ``METRICS_TPU_SYNC_CHUNKS`` parse and its
    warn-once memory."""
    _chunks_warn_once.reset()
    _ENV_SYNC_CHUNKS.reset()


def chunk_bounds(n: int, chunks: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` lanes of each chunk of an ``n``-lane bucket: at most
    ``n`` chunks, the first ``n % chunks`` one lane longer."""
    chunks = max(1, min(int(chunks), n if n else 1))
    base, rem = divmod(n, chunks)
    bounds, lo = [], 0
    for c in range(chunks):
        hi = lo + base + (1 if c < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def run_gather_jobs(
    jobs: Sequence[Tuple[Any, Callable[[], Any], Callable[[Any], Any]]],
    pipeline: bool = False,
) -> Dict[Any, Any]:
    """Run ``(key, issue, fold)`` jobs: ``issue()`` makes the job's
    collectives, ``fold(raw)`` builds its value. The ``issue`` calls always
    run in list order (collectives pair across processes by issue order).
    Sequentially each job is folded before the next is issued; with
    ``pipeline=True`` the issues run on a daemon thread, at most two ahead,
    while the calling thread folds one job behind, so a fold overlaps the
    next job's transfer. The caller holds :data:`gather_sequence_lock`. An
    ``issue`` that raises propagates to the caller; a ``fold`` that raises
    stops the issuer before its next job. Returns ``{key: fold(issue())}``,
    the same in both modes."""
    # collective seam: the caller holds gather_sequence_lock by contract
    # (not hot, so that hold is sanctioned); any other hot lock held here
    # would stall its contenders for a whole wire round-trip
    note_blocking("collective", "run_gather_jobs")
    if not pipeline or len(jobs) < 2:
        return {key: fold(issue()) for key, issue, fold in jobs}

    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    err_key = object()

    def issuer() -> None:
        try:
            for key, issue, fold in jobs:
                if stop.is_set():
                    return
                q.put((key, fold, issue()))
        except BaseException as err:  # noqa: BLE001 — relayed to the folding thread
            q.put((err_key, err, None))

    worker = threading.Thread(target=issuer, daemon=True, name="metrics-tpu-gather-pipeline")
    worker.start()
    out: Dict[Any, Any] = {}
    try:
        for _ in range(len(jobs)):
            key, fold, raw = q.get()
            if key is err_key:
                raise fold
            out[key] = fold(raw)
    finally:
        stop.set()
        # the issuer may wait on the full queue: drain until it has ended
        while worker.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
            worker.join(timeout=0.05)
    return out


# --------------------------------------------------------------------------
# fused_sync
# --------------------------------------------------------------------------

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


def _reduce_rows(rows: List[Tensor], fx: Reduction) -> Any:
    """The reduction of every rank's row, in rank order."""
    if fx == "cat":
        return torch.cat([torch.atleast_1d(p) for p in rows])
    if fx in ("sum", "mean"):
        total = rows[0]
        for r in rows[1:]:
            total = total + r
        return (total / len(rows)).to(total.dtype) if fx == "mean" else total
    if fx in ("max", "min"):
        out = rows[0]
        for r in rows[1:]:
            out = torch.maximum(out, r) if fx == "max" else torch.minimum(out, r)
        return out
    stacked = torch.stack(rows)
    if fx is None:
        return stacked
    if callable(fx):
        return fx(stacked)
    raise ValueError(f"Unsupported dist_reduce_fx: {fx!r}")


def sync_cat_buffer(buffer: CatBuffer, gather: Callable[[Tensor], List[Tensor]], dropped: Tensor,
                    gather_data: Optional[Callable[[Tensor], List[Tensor]]] = None) -> CatBuffer:
    """The union of every rank's ring: ``data`` and ``mask`` gathered and
    stacked along the capacity (masked rows stay masked), with ``dropped``,
    the ranks' summed drop count. ``gather_data`` (default ``gather``)
    carries the data."""
    data = torch.cat((gather_data or gather)(buffer.data))
    mask = torch.cat(gather(buffer.mask))
    return CatBuffer(data, mask, dropped.reshape(()))


def fused_sync(
    states: Sequence[Dict[str, Any]],
    reductions: Sequence[Dict[str, Reduction]],
    group: Optional[Any] = None,
    defaults: Optional[Sequence[Dict[str, Any]]] = None,
    comm: Optional[Any] = None,
    same_as: Optional[Sequence[Optional[int]]] = None,
    transport: Optional[str] = None,
    chunks: Optional[int] = None,
    host_codec: Optional[WireCodec] = None,
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

    ``transport`` (``ops/quantize.py``; ``None`` resolves
    ``METRICS_TPU_SYNC_TRANSPORT``, else ``exact``): with ``int8`` or
    ``fp16`` the float sum leaves (not float64) and the quantile payloads
    leave the buckets. Each is encoded on its own (no block spans two
    leaves), the payloads' level counts and ``n_seen`` as a bit-exact tail,
    into one wire, which one ``all_gather`` carries as bytes. Each rank
    decodes every rank's segments: a float sum leaf is the sum of the
    decoded rows in rank order, a sketch the fold of the decoded sketches.
    Integer buckets, the fault counters and CountMin and HyperLogLog stay
    exact, as do mean, max and min leaves.

    ``chunks``: each bucket is split into that many ``all_reduce`` calls
    (at most one per lane), issued in order on a thread while this thread
    scatters the finished chunks back (:func:`run_gather_jobs`); the
    values are bit-equal to one collective. ``None`` resolves
    ``METRICS_TPU_SYNC_CHUNKS`` with the :data:`SYNC_CHUNK_MIN_BYTES`
    floor below which a bucket keeps one collective.

    ``host_codec`` is the overlapped cycle's rule (the JAX package's
    ``wrap_gather_transport``, kept apart from ``transport``): every
    float32 or float16 tensor leaf of at least 64 lanes (sum, mean, max,
    min and list states, ring data, a quantile sketch's items) ships as its
    rank's self-describing wire, gathered as bytes, and is reduced over
    the decoded rows in rank order; every other leaf syncs as above.

    ``comm`` replaces the default communicator (see the module's
    docstring). When one of its collectives degrades, every state takes
    this rank's own value, the value of a world of one process.

    ``same_as[i] = j`` says that metric ``i`` holds the same tensors as
    metric ``j`` on this rank (a compute group of a collection). Every rank
    must send the same collectives, and groups form from each rank's own
    data, so the buckets always carry every metric; a gathered state of
    ``i`` is taken from ``j`` only when every rank says so. The ranks vote
    in the int64 max bucket, before any gather.
    """
    comm = _default_transport() if comm is None else comm
    codec = resolve_codec(transport)
    host_codec = host_codec if host_codec is not None and host_codec.name != "exact" else None
    if chunks is None:
        n_chunks, chunk_floor = resolve_sync_chunks(None), SYNC_CHUNK_MIN_BYTES
    else:
        n_chunks, chunk_floor = resolve_sync_chunks(chunks), 0
    args = (states, reductions, group, defaults, same_as, codec, n_chunks, chunk_floor, host_codec)
    with gather_sequence_lock:
        try:
            return _fused_sync(comm, *args)
        except _LocalOnly:
            return _fused_sync(_WORLD_OF_ONE, *args)


def _fused_sync(
    comm: Any,
    states: Sequence[Dict[str, Any]],
    reductions: Sequence[Dict[str, Reduction]],
    group: Optional[Any],
    defaults: Optional[Sequence[Dict[str, Any]]],
    same_as: Optional[Sequence[Optional[int]]],
    codec: WireCodec,
    n_chunks: int,
    chunk_floor: int,
    host_codec: Optional[WireCodec],
) -> List[Dict[str, Any]]:
    world, rank = comm.get_world_size(group), comm.get_rank(group)
    quantized = codec.name != "exact"

    def gather(tensor: Tensor) -> List[Tensor]:
        return _pad_gather_trim(tensor, group, comm)

    def gather_fixed(tensor: Tensor) -> List[Tensor]:
        """A leaf of the same shape on every rank, on the host wire."""
        wire = as_bytes(encode_leaf(tensor, host_codec))
        rows = _all_gather(wire, group, comm)
        return [decode_leaf(row, host_codec, tensor.numel()).to(tensor.dtype).reshape(tensor.shape) for row in rows]

    buckets: Dict[Tuple[str, torch.dtype], List[Tuple[Any, Tensor]]] = {}
    gather_merge: List[Tuple[int, str, Any]] = []
    wire_leaves: List[Tuple[int, str, Tensor]] = []
    host_leaves: List[Tuple[int, str, Tensor, str]] = []
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
                if host_codec is not None and quantizes_on_host(value):
                    host_leaves.append((i, name, value, fx))
                elif quantized and fx == "sum" and value.is_floating_point() and value.dtype != torch.float64:
                    wire_leaves.append((i, name, value))
                else:
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

    # quantile payloads: in the float32 sum bucket (exact), or on a wire
    sketch_wire = quantized or host_codec is not None
    payload_size = 0
    if gather_merge and not sketch_wire:
        payload = torch.cat([v.pack() for (_, _, v) in gather_merge])
        payload_size = payload.shape[0]
        wide = payload.new_zeros((world * payload_size,))
        wide[rank * payload_size:(rank + 1) * payload_size] = payload
        bucket("sum", wide, "sketches")

    dropped: Dict[Tuple[int, str], Tensor] = {}
    synced_slots: Dict[str, Any] = {}

    def scatter(slot: Any, leaf: Tensor) -> None:
        if slot in ("sketches", "vote"):
            synced_slots[slot] = leaf
            return
        i, name, kind = slot
        if kind == "dropped":
            dropped[(i, name)] = leaf
        elif kind is None:
            out[i][name] = leaf
        else:  # FaultCounters or an elementwise sketch
            out[i][name] = kind(leaf)

    # each bucket in chunks: one all_reduce per chunk, and once a chunk is
    # reduced every leaf that ends inside the reduced lanes is scattered;
    # the issues may run on another thread, on this thread's stream
    cuda_leaf = next((v for ls in buckets.values() for _, v in ls if v.is_cuda), None)
    stream = None if cuda_leaf is None else torch.cuda.current_stream(cuda_leaf.device)

    def issue(piece: Tensor, op: str) -> None:
        with _on_stream(stream):
            _all_reduce(comm, piece, op, group)

    def fold(_raw: Any, hi: int, synced: Tensor, leaves: List[Tuple[Any, Tensor]], fx: str, done: List[int]) -> None:
        while done[0] < len(leaves):
            slot, v = leaves[done[0]]
            lo = sum(x.numel() for _, x in leaves[:done[0]])
            if lo + v.numel() > hi:
                return
            leaf = synced[lo:lo + v.numel()].reshape(v.shape)
            scatter(slot, (leaf / world).to(leaf.dtype) if fx == "mean" else leaf)
            done[0] += 1

    jobs = []
    for (fx, dtype), leaves in buckets.items():
        synced = torch.cat([v.reshape(-1) for (_, v) in leaves])
        n = synced.shape[0]
        k = n_chunks if n_chunks > 1 and n * synced.element_size() >= chunk_floor else 1
        done = [0]  # the bucket's leaves scattered so far
        for lo, hi in chunk_bounds(n, k):
            jobs.append((
                (fx, dtype, lo),
                functools.partial(issue, synced[lo:hi], _REDUCE_OPS[fx]),
                functools.partial(fold, hi=hi, synced=synced, leaves=leaves, fx=fx, done=done),
            ))
    run_gather_jobs(jobs, pipeline=len(jobs) > len(buckets))

    if gather_merge and not sketch_wire:
        per_rank = synced_slots["sketches"].reshape(-1, payload_size)
        offset = 0
        for (i, name, v) in gather_merge:
            size = v.packed_size
            merged = None
            for part in per_rank:
                s = type(v).unpack_like(part[offset:offset + size], v)
                merged = s if merged is None else merged.sketch_merge(s)
            out[i][name] = merged
            offset += size
    if quantized and (wire_leaves or gather_merge):
        _quantized_wire_sync(out, wire_leaves, gather_merge, codec, group, comm)
    elif host_codec is not None and gather_merge:
        _quantized_wire_sync(out, [], gather_merge, host_codec, group, comm)
    for (i, name, value, fx) in host_leaves:
        out[i][name] = _reduce_rows(gather_fixed(value), fx)

    # a metric that every rank says holds another's tensors takes that
    # metric's gathered states
    shared = {}
    if "vote" in synced_slots:
        votes = synced_slots["vote"].tolist()
        shared = {i: votes[i] for i in range(n_metrics) if votes[i] != i and votes[i] == -votes[n_metrics + i]}
    for (i, name, value, fx) in passthrough:
        if i in shared:
            continue
        if isinstance(value, CatBuffer):
            data_gather = gather_fixed if host_codec is not None and quantizes_on_host(value.data) else None
            out[i][name] = sync_cat_buffer(value, gather, dropped[(i, name)], data_gather)
        elif isinstance(value, list):
            template = defaults[i].get(name) if defaults is not None else None
            local = _list_local(value, template, states[i])
            parts = _host_ragged_gather(local, group, comm, host_codec) if host_codec is not None else gather(local)
            out[i][name] = [t for t in parts if t.shape[0]]
        else:
            out[i][name] = _reduce_rows(gather(value), fx)
    for (i, name, _, _) in passthrough:
        if i in shared:
            out[i][name] = out[shared[i]][name]
    return out


def _host_ragged_gather(local: Tensor, group: Any, comm: Any, codec: WireCodec) -> List[Tensor]:
    """A list state on the host wire. Ranks hold lists of different lengths,
    so each decides for itself, as the JAX package's per-leaf rule does:
    a rank whose rows :func:`quantizes_on_host` sends a flag byte 1 and its
    wire, any other a flag byte 0 and its raw bytes. Every rank then sends
    bytes, so the ragged gather always pairs."""
    trailing = tuple(local.shape[1:])
    if quantizes_on_host(local):
        body = as_bytes(encode_leaf(local, codec))
    else:
        body = as_bytes(local)
    flag = torch.tensor([1 if quantizes_on_host(local) else 0], dtype=torch.uint8, device=local.device)
    rows = _pad_gather_trim(torch.cat([flag, body]), group, comm)
    out = []
    for row in rows:
        if int(row[0]):
            out.append(decode_leaf(row[1:], codec).to(local.dtype).reshape((-1,) + trailing))
        else:
            out.append(from_bytes(row[1:], local.dtype).reshape((-1,) + trailing))
    return out


def _quantized_wire_sync(
    out: List[Dict[str, Any]],
    wire_leaves: List[Tuple[int, str, Tensor]],
    gather_merge: List[Tuple[int, str, Any]],
    codec: WireCodec,
    group: Any,
    comm: Any,
) -> None:
    """The quantized wire: encode, one ``all_gather`` of the bytes, decode.

    Each float sum leaf and each quantile payload is encoded on its own
    (no block spans two leaves), the payloads' level counts and ``n_seen``
    as a bit-exact tail, into one wire that every rank gathers. Each rank
    decodes every rank's segments: a float sum leaf is the sum of the
    decoded rows in rank order (each rank's part quantized once with its
    own block scales: the error per lane is at most the sum over ranks of
    the codec's block envelope), a sketch the fold of the decoded sketches
    in rank order. The bytes are those of the JAX package's
    scatter-into-zeros and ``psum``."""
    segments = []  # (kind, i, name, flat float32 payload, exact tail, original)
    for (i, name, v) in wire_leaves:
        segments.append(("leaf", i, name, v.to(torch.float32).reshape(-1), 0, v))
    for (i, name, v) in gather_merge:
        # the packed layout: items (L*k), then the counts (L) and the split
        # n_seen (2), the exact tail
        segments.append(("sketch", i, name, v.pack(), v.counts.shape[0] + 2, v))
    wires = [codec.encode(vec, tail) for (_, _, _, vec, tail, _) in segments]
    sizes = [w.shape[0] for w in wires]
    wire = torch.cat(wires)
    # the wire's bytes beside the float32 lanes it replaces (a host instant)
    from metrics_tpu_torch.obs import trace as _obs_trace

    _obs_trace.instant(
        "sync.quantized_wire",
        transport=codec.name,
        wire_bytes=int(wire.numel()) * wire.element_size(),
        exact_bytes=int(sum(vec.shape[0] for (_, _, _, vec, _, _) in segments) * 4),
    )
    per_rank = [row.view(codec.wire_dtype) for row in _all_gather(as_bytes(wire), group, comm)]
    offset = 0
    for (kind, i, name, vec, tail, orig), size in zip(segments, sizes):
        rows = [codec.decode(w[offset:offset + size], vec.shape[0], tail) for w in per_rank]
        if kind == "leaf":
            total = rows[0]
            for r in rows[1:]:
                total = total + r
            out[i][name] = total.reshape(orig.shape).to(orig.dtype)
        else:
            merged = None
            for r in rows:
                s = type(orig).unpack_like(r, orig)
                merged = s if merged is None else merged.sketch_merge(s)
            out[i][name] = merged
        offset += size



# --------------------------------------------------------------------------
# one state, one leaf, one sketch (``group=`` in place of ``axis_name``)
# --------------------------------------------------------------------------


def sync_state(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Optional[Any] = None,
    defaults: Optional[Dict[str, Any]] = None,
    comm: Optional[Any] = None,
) -> Dict[str, Any]:
    """One metric's states synced over ``group`` through one
    :func:`fused_sync`. As in the JAX package, a list state syncs to one
    tensor, the concatenation of every rank's rows (an empty rank sends the
    list's template from ``defaults``), and a ``None``-reduced tensor to the
    ranks' values stacked on a new leading axis."""
    flat: Dict[str, Any] = {}
    reds: Dict[str, Reduction] = {}
    for name, value in state.items():
        fx = reductions[name]
        if isinstance(value, list) or type(value) is tuple:
            template = defaults.get(name) if defaults else None
            value = _list_local(list(value), template, state)
            fx = "cat" if fx in ("cat", None) else fx
        flat[name], reds[name] = value, fx
    (synced,) = fused_sync([flat], [reds], group, comm=comm, transport="exact")
    return synced


def sync_leaf(value: Tensor, reduce_fx: Reduction, group: Optional[Any] = None, comm: Optional[Any] = None) -> Tensor:
    """One tensor synced by its reduction tag: one ``all_reduce`` for
    ``sum``/``mean``/``max``/``min``, a gather for ``cat`` (the rows
    concatenated), ``None`` (stacked) and a callable (applied to the
    stacked rows)."""
    return sync_state({"leaf": value}, {"leaf": reduce_fx}, group, comm=comm)["leaf"]


def sync_sketch_state(value: Any, group: Optional[Any] = None, comm: Optional[Any] = None) -> Any:
    """The union of every rank's sketch state: an elementwise sketch in one
    ``all_reduce``, a quantile sketch through its packed payload and
    ``sketch_merge`` in rank order (every rank computes the same sketch)."""
    return sync_state({"sketch": value}, {"sketch": None}, group, comm=comm)["sketch"]


# --------------------------------------------------------------------------
# plain local reductions, kept for the reference's API
# --------------------------------------------------------------------------


def reduce(x: Tensor, reduction: Optional[str]) -> Tensor:
    """``elementwise_mean``, ``sum`` or ``none`` of a tensor (local, no
    communication)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: Optional[str] = "none") -> Tensor:
    """A per-class fraction reduced ``micro``, ``macro``, ``weighted`` or
    not at all; a class with a zero denominator counts as 0."""
    valid = ("micro", "macro", "weighted", "none", None)
    if class_reduction not in valid:
        raise ValueError(f"Reduction parameter {class_reduction!r} unknown, choose from {valid}")
    if class_reduction == "micro":
        return torch.sum(num) / torch.sum(denom)
    fraction = num.to(torch.float32) / torch.where(denom == 0, torch.ones_like(denom), denom)
    fraction = torch.where(denom == 0, torch.zeros_like(fraction), fraction)
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights.to(torch.float32) / torch.sum(weights)))
    return fraction
