"""The step-budget auditor (counterpart of ``metrics_tpu/analysis/graph_audit.py``):
structural assertions on what one step of a flagship path sends and runs.

The JAX package lowers each entry to optimized HLO and counts strings in
it. The port has no graph text: its steps are eager PyTorch (captured into
CUDA graphs on the card), so each budget gets a counterpart that *runs* the
step and records it (ROADMAP D66):

- **Collectives** go through a recording communicator, :class:`MirrorWorld`:
  one rank of a world of ``n`` whose other ranks hold the same tensors (a
  sum multiplies by ``n``, a gather repeats the tensor). Every rank sends
  the same collectives, so one rank gives the counts and the bytes.
  ``Metric(dist_sync_fn=...)`` and ``fused_sync(comm=...)`` take it (D15);
  :func:`mirrored` installs it as the default communicator for the pure
  layer's syncs. No rank runs as a thread.
- **The chunked schedule** (``fused_sync(chunks=k)``) issues ``k``
  ``all_reduce`` calls over consecutive lanes of one bucket's flat tensor.
  :func:`collective_counts` folds a call that continues the previous one
  (same kind, dtype and storage, starting where it ended) into one LOGICAL
  collective, as the JAX package folds the ops its
  ``fused_sync_chunk_<i>of<k>`` markers tag; :func:`physical_collective_counts`
  counts every call.
- **No float64, no read to the host, no value-shaped op**: the step runs
  under a recorder of aten ops (``TorchDispatchMode``, as
  ``torch.utils.flop_counter`` does) and of the tensor methods that read
  back (``TorchFunctionMode``). It flags a float64 or complex128 output; a
  read to the host (``.item()``, ``.tolist()``, ``.numpy()``, ``bool()``,
  ``float()``, ``int()``, ``torch.equal``, a copy of a CUDA tensor to the
  CPU); and an op whose output shape depends on values (``nonzero``,
  ``masked_select``, ``unique``, boolean indexing). It sees the same ops on
  the CPU as on the card: a kernel of the port is launched through
  ``ctypes`` and is no aten op on either.
- **Recompilation**: the counterpart of a jit trace is a CUDA-graph capture
  (``_capture.py``), keyed by the update's argument shapes and its
  data-inferred attributes. :func:`audit_recompilation` counts the keys a
  metric's update captures under — on the CPU through a stand-in capture
  that runs the body as a replay would, on the card through real
  captures — and checks JAX's four properties: state shapes independent of
  the batch size, one key at equal shapes, at most ``max_graphs`` keys over
  a ragged sweep, and no new key after a warmup. A pure-layer step is never
  captured (ROADMAP item 11b): its keys and state shapes are audited, and
  it captures nothing.

Each step may mark a phase (:func:`audit_phase`): ``compute()`` is eager
and reads back by design (D38), so a budget can allow a measured number of
reads in the ``compute`` phase while the update keeps JAX's zero (D68).

torch is imported where it is used, so ``metrics_tpu_torch.analysis``
imports (and the AST lint runs) without it.
"""
import contextlib
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

# the tensor methods (and torch functions) whose call reads a value back to
# the host; `cpu`/`to` only when they move a CUDA tensor to the CPU
_READ_METHODS = frozenset(
    {"item", "tolist", "numpy", "__bool__", "__float__", "__int__", "__index__", "__complex__", "equal"}
)
_MOVE_METHODS = frozenset({"cpu", "to"})

# aten ops whose output shape depends on the input's values
_VALUE_SHAPED_OPS = frozenset(
    {"nonzero", "nonzero_numpy", "argwhere", "masked_select", "_unique", "_unique2", "unique_dim", "unique_consecutive"}
)
_BOOL_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})

_HLO_DTYPES = {
    "bool": "pred",
    "int8": "s8",
    "uint8": "u8",
    "float16": "f16",
    "bfloat16": "bf16",
    "int16": "s16",
    "uint16": "u16",
    "float32": "f32",
    "int32": "s32",
    "uint32": "u32",
    "float64": "f64",
    "int64": "s64",
    "uint64": "u64",
    "complex64": "c64",
    "complex128": "c128",
}


def hlo_dtype(dtype: Any) -> str:
    """The JAX package's HLO dtype token of a torch dtype (``f32``, ``u8``)."""
    return _HLO_DTYPES.get(str(dtype).replace("torch.", ""), str(dtype).replace("torch.", ""))


@dataclass(frozen=True)
class GraphBudget:
    """Structural ceilings for one step (the JAX package's fields).

    ``max_*`` of ``None`` means "don't care"; the ``allow_*`` knobs default
    to the invariants: no float64, no read to the host, no value-shaped op.
    ``require_patterns``/``forbid_patterns`` are regexes over the step's
    record (:meth:`StepTrace.text`): one line per physical collective, as
    ``all-gather u8[4608] logical_0 chunk_0of1``, and one per aten op.
    ``compute_host_reads`` is the port's own: the reads to the host allowed
    in the ``compute`` phase of a step (D68); the update keeps the zero.
    """

    max_all_reduce: Optional[int] = None
    max_all_gather: Optional[int] = None
    max_reduce_scatter: Optional[int] = None
    max_collective_permute: Optional[int] = None
    max_all_to_all: Optional[int] = None
    allow_f64: bool = False
    allow_host_callback: bool = False
    allow_dynamic_shapes: bool = False
    require_patterns: Tuple[str, ...] = ()
    forbid_patterns: Tuple[str, ...] = ()
    compute_host_reads: int = 0

    def collective_ceilings(self) -> Dict[str, Optional[int]]:
        return {
            "all-reduce": self.max_all_reduce,
            "all-gather": self.max_all_gather,
            "reduce-scatter": self.max_reduce_scatter,
            "collective-permute": self.max_collective_permute,
            "all-to-all": self.max_all_to_all,
        }


@dataclass(frozen=True)
class GraphViolation:
    entry: str
    kind: str  # "collective-budget" | "f64" | "host-callback" | "dynamic-shape" | "recompilation" | "missing-pattern" | "forbidden-pattern"
    detail: str

    def format(self) -> str:
        return f"{self.entry}: [{self.kind}] {self.detail}"


class GraphBudgetError(AssertionError):
    """A step exceeded its structural budget."""

    def __init__(self, violations: Sequence[GraphViolation]) -> None:
        self.violations = list(violations)
        super().__init__(
            "step budget violated:\n" + "\n".join(f"  - {v.format()}" for v in self.violations)
        )


# ---------------------------------------------------------------------------
# the recording communicator
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Collective:
    """One physical collective as this rank sent it. ``logical`` numbers
    the logical collective it belongs to, ``chunk`` its place in it;
    ``payload_bytes`` is the size of its result (a gather's: ``n`` times
    the tensor), the JAX package's ``collective_payload_bytes`` rule."""

    op: str
    dtype: str
    shape: Tuple[int, ...]
    reduce_op: Optional[str]
    payload_bytes: int
    logical: int
    chunk: int


class MirrorWorld:
    """One rank (``rank``) of a world of ``n`` whose other ranks hold the
    same tensors, recording every collective: the communicator the audit
    hands a step (``torch.distributed``'s ``all_reduce``, ``all_gather``,
    ``reduce_scatter``, ``get_world_size``, ``get_rank``)."""

    def __init__(self, n: int = 4, rank: int = 0) -> None:
        self.n, self.rank = int(n), int(rank)
        # no lock: the syncs issue their collectives in order under the
        # process-wide gather_sequence_lock, one thread at a time
        self.collectives: List[Collective] = []
        self._tail: Optional[Tuple[str, str, int, int]] = None  # (op, dtype, storage, end lane)
        self._logical = -1
        self._chunk = 0

    def get_world_size(self, group: Any = None) -> int:
        return self.n

    def get_rank(self, group: Any = None) -> int:
        return self.rank

    def clear(self) -> None:
        self.collectives = []
        self._tail = None
        self._logical = -1

    def _note(self, op: str, tensor: Any, reduce_op: Optional[str], payload_bytes: int) -> None:
        dtype = hlo_dtype(tensor.dtype)
        storage = tensor.untyped_storage().data_ptr() if tensor.numel() else 0
        start = tensor.storage_offset()
        if op == "all-reduce" and self._tail == (op, dtype, storage, start):
            self._chunk += 1  # the next lanes of the same bucket: one logical collective
        else:
            self._logical += 1
            self._chunk = 0
        self._tail = (op, dtype, storage, start + tensor.numel())
        self.collectives.append(
            Collective(op, dtype, tuple(tensor.shape), reduce_op, int(payload_bytes), self._logical, self._chunk)
        )

    def all_reduce(self, tensor: Any, op: Any = None, group: Any = None, async_op: bool = False) -> None:
        name = "SUM" if op is None else str(op).split(".")[-1].upper()
        self._note("all-reduce", tensor, name, tensor.numel() * tensor.element_size())
        if name == "SUM":
            tensor.mul_(self.n)

    def all_gather(self, parts: List[Any], tensor: Any, group: Any = None, async_op: bool = False) -> None:
        self._note("all-gather", tensor, None, self.n * tensor.numel() * tensor.element_size())
        for part in parts:
            part.copy_(tensor)

    def reduce_scatter(self, output: Any, input_list: List[Any], op: Any = None, group: Any = None, async_op: bool = False) -> None:
        name = "SUM" if op is None else str(op).split(".")[-1].upper()
        self._note("reduce-scatter", input_list[self.rank], name, output.numel() * output.element_size())
        output.copy_(input_list[self.rank])
        if name == "SUM":
            output.mul_(self.n)


# the process group the pure layer is handed under an audit: a stand-in
# that the mirror world ignores (its syncs name a group, not a world)
MIRROR_GROUP = "mirror"


@contextlib.contextmanager
def mirrored(world: MirrorWorld) -> Iterator[MirrorWorld]:
    """Within the block, ``world`` is the default communicator of every
    sync (``parallel/sync.py::set_gather_transport``): the pure layer's
    ``group=`` syncs go through it."""
    from metrics_tpu_torch.parallel.sync import set_gather_transport

    prev = set_gather_transport(world)
    try:
        yield world
    finally:
        set_gather_transport(prev)


# ---------------------------------------------------------------------------
# the recorder of ops
# ---------------------------------------------------------------------------

_phase = threading.local()


@contextlib.contextmanager
def audit_phase(name: str) -> Iterator[None]:
    """Label the ops recorded on this thread within the block (a step's
    ``update``, ``sync`` or ``compute``)."""
    prev = getattr(_phase, "name", "step")
    _phase.name = name
    try:
        yield
    finally:
        _phase.name = prev


def _current_phase() -> str:
    return getattr(_phase, "name", "step")


@dataclass
class OpRecord:
    name: str  # aten.<op>.<overload>
    phase: str
    outputs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    flags: Tuple[str, ...] = ()  # "f64" | "dynamic-shape"


@dataclass
class StepTrace:
    """What one recorded step sent and ran."""

    collectives: List[Collective] = field(default_factory=list)
    ops: List[OpRecord] = field(default_factory=list)
    host_reads: List[Tuple[str, str]] = field(default_factory=list)  # (what, phase)
    bytes_accessed: int = 0

    def text(self) -> str:
        """The record as lines, the port's counterpart of the HLO text that
        the JAX package's patterns search."""
        k = {}
        for c in self.collectives:
            k[c.logical] = k.get(c.logical, 0) + 1
        lines = [
            f"{c.op} {c.dtype}[{','.join(map(str, c.shape))}]{' ' + c.reduce_op.lower() if c.reduce_op else ''} "
            f"logical_{c.logical} chunk_{c.chunk}of{k[c.logical]}"
            for c in self.collectives
        ]
        for op in self.ops:
            outs = ",".join(f"{d}[{','.join(map(str, s))}]" for d, s in op.outputs)
            lines.append(f"{op.phase}: {op.name} -> {outs}")
        for what, phase in self.host_reads:
            lines.append(f"{phase}: host-read {what}")
        return "\n".join(lines)

    def flagged(self, flag: str) -> List[OpRecord]:
        return [op for op in self.ops if flag in op.flags]


def _tensors_in(tree: Any) -> List[Any]:
    import torch
    from torch.utils._pytree import tree_flatten

    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _OpRecorder:
    """The two modes of one recording, built lazily (torch imported)."""

    def __init__(self, trace: StepTrace) -> None:
        import torch
        from torch.overrides import TorchFunctionMode
        from torch.utils._python_dispatch import TorchDispatchMode

        recorder = self

        class _Dispatch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):  # noqa: ANN001
                out = func(*args, **(kwargs or {}))
                recorder._note_op(func, args, kwargs or {}, out)
                return out

        class _Functions(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):  # noqa: ANN001
                out = func(*args, **(kwargs or {}))
                recorder._note_call(func, args, kwargs or {}, out)
                return out

        self.trace = trace
        self._torch = torch
        # the host copies of CUDA tensors this step made, by id (held, so no
        # id is reused): reading one back (`x.cpu().numpy()`) is the same
        # read, counted at the copy
        self._moved: Dict[int, Any] = {}
        self._dispatch = _Dispatch()
        self._functions = _Functions()

    def __enter__(self) -> "_OpRecorder":
        self._functions.__enter__()
        self._dispatch.__enter__()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._dispatch.__exit__(*exc)
        self._functions.__exit__(*exc)

    def _note_call(self, func: Any, args: tuple, kwargs: dict, out: Any) -> None:
        """One read per value brought to the host, on either device: a
        scalar or list read of a tensor, or the copy of a CUDA tensor to the
        CPU (whose later ``.numpy()`` is the same read)."""
        torch = self._torch
        name = getattr(func, "__name__", "")
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if name in _READ_METHODS:
            if src is None or id(src) not in self._moved:
                self.trace.host_reads.append((name, _current_phase()))
        elif name in _MOVE_METHODS and src is not None and src.is_cuda and isinstance(out, torch.Tensor) and not out.is_cuda:
            self._moved[id(out)] = out
            self.trace.host_reads.append((name, _current_phase()))

    def _note_op(self, func: Any, args: tuple, kwargs: dict, out: Any) -> None:
        torch = self._torch
        base = func.overloadpacket.__name__
        outs = _tensors_in(out)
        flags = []
        if any(t.dtype in (torch.float64, torch.complex128) for t in outs):
            flags.append("f64")
        if base in _VALUE_SHAPED_OPS or (
            base in _BOOL_INDEX_OPS
            and any(t.dtype in (torch.bool, torch.uint8) for t in _tensors_in(args[1:2]))
        ):
            flags.append("dynamic-shape")
        if base == "copy_" and len(args) >= 2 and isinstance(args[1], torch.Tensor) and args[1].is_cuda and not args[0].is_cuda:
            self.trace.host_reads.append(("copy_ to the CPU", _current_phase()))
        if not getattr(func, "is_view", False):
            self.trace.bytes_accessed += sum(
                t.numel() * t.element_size() for t in _tensors_in((args, kwargs)) + outs
            )
        self.trace.ops.append(
            OpRecord(
                f"aten.{base}.{func._overloadname}",
                _current_phase(),
                tuple((hlo_dtype(t.dtype), tuple(t.shape)) for t in outs),
                tuple(flags),
            )
        )


def record_step(
    fn: Callable, args: Tuple = (), kwargs: Optional[Dict[str, Any]] = None, world: Optional[MirrorWorld] = None
) -> Tuple[Any, StepTrace]:
    """Run ``fn(*args, **kwargs)`` once under the recorders; returns its
    result and the :class:`StepTrace`. ``world`` (cleared first) is
    installed as the default communicator for the call and its
    collectives join the trace."""
    trace = StepTrace()
    ctx = mirrored(world) if world is not None else contextlib.nullcontext()
    if world is not None:
        world.clear()
    with ctx, _OpRecorder(trace):
        out = fn(*args, **(kwargs or {}))
    if world is not None:
        trace.collectives = list(world.collectives)
    return out, trace


def collective_counts(trace: StepTrace) -> Dict[str, int]:
    """LOGICAL collectives of one step, by op name: the calls of a chunked
    schedule fold into one (see the module's docstring)."""
    counts = {op: 0 for op in COLLECTIVE_OPS}
    for c in trace.collectives:
        if c.chunk == 0:
            counts[c.op] += 1
    return counts


def physical_collective_counts(trace: StepTrace) -> Dict[str, int]:
    """Every collective call of one step, chunks counted one by one."""
    counts = {op: 0 for op in COLLECTIVE_OPS}
    for c in trace.collectives:
        counts[c.op] += 1
    return counts


def collective_payload_bytes(trace: StepTrace) -> Dict[str, int]:
    """Payload bytes per collective op of one step (a chunked schedule's
    pieces sum to the bucket it split)."""
    out = {op: 0 for op in COLLECTIVE_OPS}
    for c in trace.collectives:
        out[c.op] += c.payload_bytes
    return out


def _by_phase(reads: Sequence[Tuple[str, str]]) -> Tuple[int, int]:
    """(outside the compute phase, inside it)."""
    inside = sum(1 for _, phase in reads if phase == "compute")
    return len(reads) - inside, inside


def audit_trace(trace: StepTrace, budget: GraphBudget, entry: str = "<fn>") -> List[GraphViolation]:
    """Check one recorded step against a budget; returns violations (no
    raise). The counterpart of ``audit_hlo``, with JAX's ``kind`` strings."""
    violations: List[GraphViolation] = []
    counts = collective_counts(trace)
    for op, ceiling in budget.collective_ceilings().items():
        if ceiling is not None and counts[op] > ceiling:
            violations.append(
                GraphViolation(entry, "collective-budget", f"{counts[op]} {op} ops, budget allows {ceiling}")
            )
    f64 = trace.flagged("f64")
    if not budget.allow_f64 and f64:
        violations.append(
            GraphViolation(
                entry,
                "f64",
                f"{len(f64)} float64/complex128 op(s) in the step ({f64[0].name}) — an accidental "
                "double-precision promotion (the H100 runs float64 at a fraction of float32's rate)",
            )
        )
    if not budget.allow_host_callback:
        outside, inside = _by_phase(trace.host_reads)
        if outside or inside > budget.compute_host_reads:
            what = sorted({w for w, _ in trace.host_reads})
            violations.append(
                GraphViolation(
                    entry,
                    "host-callback",
                    f"{outside} read(s) to the host outside compute and {inside} in it (budget "
                    f"{budget.compute_host_reads} in compute): {what} — every step waits for the card",
                )
            )
    shaped = trace.flagged("dynamic-shape")
    if not budget.allow_dynamic_shapes and shaped:
        violations.append(
            GraphViolation(
                entry,
                "dynamic-shape",
                f"{len(shaped)} value-shaped op(s) in the step: {sorted({op.name for op in shaped})} — "
                "an output shape read from the data cannot be captured",
            )
        )
    text = trace.text()
    for pattern in budget.require_patterns:
        if not re.search(pattern, text):
            violations.append(
                GraphViolation(entry, "missing-pattern", f"required pattern {pattern!r} not found in the step's record")
            )
    for pattern in budget.forbid_patterns:
        match = re.search(pattern, text)
        if match:
            violations.append(
                GraphViolation(
                    entry, "forbidden-pattern", f"forbidden pattern {pattern!r} matched ({match.group(0)[:60]!r})"
                )
            )
    return violations


def assert_graph_budget(
    fn: Callable,
    args: Tuple = (),
    kwargs: Optional[Dict[str, Any]] = None,
    budget: GraphBudget = GraphBudget(),
    entry: Optional[str] = None,
    world: Optional[MirrorWorld] = None,
) -> Dict[str, int]:
    """Record one step of ``fn`` and enforce ``budget``; returns the
    logical collective counts, raising :class:`GraphBudgetError` with the
    per-violation breakdown on overrun."""
    name = entry or getattr(fn, "__name__", None) or type(fn).__name__
    _, trace = record_step(fn, args, kwargs, world=world)
    violations = audit_trace(trace, budget, entry=name)
    if violations:
        raise GraphBudgetError(violations)
    return collective_counts(trace)


# ---------------------------------------------------------------------------
# recompilation: capture keys and captures
# ---------------------------------------------------------------------------


def _replay_stand_in(run: Callable[[], None], pool: Any) -> Callable[[], None]:
    """The CPU's capture step: records nothing and returns the body, which
    the table then runs as each replay (under the capture's value-checks-off
    rule, as a replay on the card runs)."""
    return run


def stand_in_captures(metric: Any) -> Any:
    """On the CPU, give each member of ``metric`` (a metric or a
    collection) whose update the card would capture a table of stand-in
    captures, so its updates key, capture and replay as on the card; on
    CUDA the members' own tables capture. Returns ``metric``."""
    from metrics_tpu_torch._capture import UpdateGraphs

    for m in _members(metric):
        if m.device.type != "cuda" and m._can_jit_update() and not m.compute_on_cpu and not m.debug_checks:
            object.__setattr__(m, "_update_graphs", UpdateGraphs(capture=_replay_stand_in))
    return metric


def _members(metric: Any) -> List[Any]:
    """The top-level metrics of a collection, or the metric itself."""
    from metrics_tpu_torch.collections import MetricCollection

    if isinstance(metric, MetricCollection):
        return [m for _, m in metric.items(keep_base=True, copy_state=False)]
    return [metric]


def graph_counts(metric: Any) -> Dict[str, int]:
    """``{"keys", "captures", "replays"}`` over the members' capture
    tables (zeros where nothing keys)."""
    out = {"keys": 0, "captures": 0, "replays": 0}
    for m in _members(metric):
        table = m.__dict__.get("_update_graphs")
        if table is not None:
            out["keys"] += len(table.seen | set(table.entries))
            out["captures"] += table.captures
            out["replays"] += table.replays
    return out


def _leaf_layout(tree: Any, prefix: str = "") -> Tuple[Tuple[str, Tuple[int, ...], str], ...]:
    """(path, shape, dtype) of every tensor leaf of a state tree."""
    import torch

    out: List[Tuple[str, Tuple[int, ...], str]] = []
    if isinstance(tree, torch.Tensor):
        out.append((prefix, tuple(tree.shape), hlo_dtype(tree.dtype)))
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out.extend(_leaf_layout(tree[k], f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            out.extend(_leaf_layout(v, f"{prefix}.{fields[i] if fields else i}"))
    return tuple(out)


class StatefulTarget:
    """A stateful metric's update as the recompilation audit drives it:
    ``make(device)`` builds a fresh metric (its update captured on the
    card, a stand-in capture on the CPU); one call is one update."""

    captured = True

    def __init__(self, make: Callable[[Any], Any]) -> None:
        self.make = make

    def fresh(self, device: Any) -> "_StatefulRun":
        return _StatefulRun(stand_in_captures(self.make(device)))


class _StatefulRun:
    def __init__(self, metric: Any) -> None:
        self.metric = metric

    def update(self, args: tuple, kwargs: dict) -> None:
        self.metric.update(*args, **kwargs)

    def layout(self) -> Tuple:
        return _leaf_layout({i: dict(m._state) for i, m in enumerate(_members(self.metric))})

    def counts(self) -> Dict[str, int]:
        return graph_counts(self.metric)

    def warm(self, tier_args: Sequence[Tuple[tuple, dict]]) -> int:
        """The warmup engine's move (``serving/warmup.py``): an eager
        pre-pass on an isolated clone resolves the data-inferred
        attributes, then each tier's graph is captured against this
        metric's states without running. Returns the graphs captured."""
        from metrics_tpu_torch._capture import eager_updates
        from metrics_tpu_torch.serving.loop import _apply_inferred_attrs, _clone, _inferred_attrs

        captured = 0
        for m in _members(self.metric):
            clone = _clone(m)
            with eager_updates():
                for args, kwargs in tier_args:
                    clone.update(*args, **kwargs)
            _apply_inferred_attrs(m, _inferred_attrs(clone))
            table = m._update_graph_table()
            for args, kwargs in tier_args:
                args = tuple(m._to_device(a) for a in args)
                kwargs = {k: m._to_device(v) for k, v in kwargs.items()}
                if table is not None and table.prepare(m, m._original_update, args, kwargs):
                    captured += 1
        return captured


class PureTarget:
    """A pure-layer update (``update(state, *args) -> state``) as the
    recompilation audit drives it: never captured (ROADMAP item 11b), so
    its keys are the argument keys a capture would take and its layout the
    returned state's."""

    captured = False

    def __init__(self, make: Callable[[Any], Tuple[Callable, Callable]]) -> None:
        self.make = make  # device -> (init, update)

    def fresh(self, device: Any) -> "_PureRun":
        init, update = self.make(device)
        return _PureRun(init, update)


class _PureRun:
    def __init__(self, init: Callable, update: Callable) -> None:
        self._update = update
        self.state = init()
        self.keys: set = set()

    def update(self, args: tuple, kwargs: dict) -> None:
        from metrics_tpu_torch._capture import _arg_key

        self.keys.add(_arg_key(args, kwargs))
        self.state = self._update(self.state, *args, **kwargs)

    def layout(self) -> Tuple:
        return _leaf_layout(self.state)

    def counts(self) -> Dict[str, int]:
        return {"keys": len(self.keys), "captures": 0, "replays": 0}


def audit_recompilation(
    target: Any,
    make_args: Callable[[int, Any], Tuple[tuple, dict]],
    batch_sizes: Tuple[int, int] = (4, 8),
    entry: str = "<fn>",
    sweep_sizes: Optional[Sequence[int]] = None,
    max_graphs: Optional[int] = None,
    warmup_sizes: Optional[Sequence[int]] = None,
    max_new_graphs: int = 0,
    device: Any = "cpu",
    report: Optional[Dict[str, Any]] = None,
) -> List[GraphViolation]:
    """Detect avoidable recompilation of an update (the JAX package's four
    checks, on capture keys; see the module's docstring).

    ``target`` is a :class:`StatefulTarget` or :class:`PureTarget`;
    ``make_args(batch, device)`` gives one update's ``(args, kwargs)``.

    1. **Batch-size-independent state shapes**: updates at each of
       ``batch_sizes`` on fresh targets leave the same state layout.
    2. **One key at equal shapes**: two updates at identical shapes key
       once.
    3. With ``sweep_sizes`` + ``max_graphs``: every sweep size through the
       same target keys at most ``max_graphs`` times (check 2's included).
    4. With ``warmup_sizes`` + ``sweep_sizes``: a fresh target warmed at
       ``warmup_sizes`` (the warmup engine's capture, nothing run) keys at
       most ``max_new_graphs`` new graphs over the sweep.

    ``report``, when given, receives the keys and captures each check saw
    (``chip_smoke.py`` holds the card's against the CPU's).
    """
    violations: List[GraphViolation] = []
    report = report if report is not None else {}
    b0, b1 = batch_sizes
    layouts = []
    for b in (b0, b1):
        run = target.fresh(device)
        run.update(*make_args(b, device))
        layouts.append(run.layout())
    if layouts[0] != layouts[1]:
        violations.append(
            GraphViolation(
                entry,
                "recompilation",
                f"state shapes depend on the batch size (batch {b0}: {layouts[0]} != batch {b1}: "
                f"{layouts[1]}) — every downstream graph recaptures per batch size",
            )
        )

    run = target.fresh(device)
    run.update(*make_args(b0, device))
    run.update(*make_args(b0, device))  # fresh args, identical shapes
    stable = run.counts()
    report["stable"] = stable
    n_members = len(_members(run.metric)) if isinstance(run, _StatefulRun) else 1
    if stable["keys"] != n_members:
        violations.append(
            GraphViolation(
                entry,
                "recompilation",
                f"{stable['keys']} capture keys for two updates at identical shapes ({n_members} "
                "member(s)) — the graph cache is being missed (an unstable attribute or argument?)",
            )
        )
    if warmup_sizes is not None:
        if sweep_sizes is None:
            raise ValueError("`warmup_sizes` needs `sweep_sizes` to serve after warmup")
        # a FRESH target: check 2's updates already keyed the b0 tier, and
        # crediting that graph would hide a warmup gap at exactly that tier
        warm = target.fresh(device)
        warmed = warm.warm([make_args(n, device) for n in warmup_sizes])
        before = warm.counts()
        for n in sweep_sizes:
            warm.update(*make_args(n, device))
        after = warm.counts()
        new = after["keys"] - before["keys"]  # keys no warmed graph served
        report["warmed"] = {"warmed": warmed, "before": before, "after": after, "new_keys": new}
        if new > max_new_graphs:
            violations.append(
                GraphViolation(
                    entry,
                    "recompilation",
                    f"{new} NEW capture key(s) while serving a {len(tuple(sweep_sizes))}-size ragged "
                    f"sweep after warming sizes {tuple(warmup_sizes)} (budget: {max_new_graphs}) — the "
                    "warmup matrix has a gap; a first live request on the missed tier runs eagerly and "
                    "captures on the request path (serving/warmup.py)",
                )
            )
    elif sweep_sizes is not None:
        if max_graphs is None:
            raise ValueError("`sweep_sizes` needs a `max_graphs` budget")
        for n in sweep_sizes:
            run.update(*make_args(n, device))
        swept = run.counts()
        report["sweep"] = swept
        per_member = swept["keys"] / n_members
        if per_member > max_graphs:
            violations.append(
                GraphViolation(
                    entry,
                    "recompilation",
                    f"{per_member:g} graphs keyed for a sweep of {len(tuple(sweep_sizes))} ragged batch "
                    f"sizes (budget: {max_graphs}) — serving traffic would recapture unboundedly; pad "
                    "batches to a capacity ladder (ops/padding.py)",
                )
            )
    return violations
