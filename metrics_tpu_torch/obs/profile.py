"""The step cost profiler (counterpart of ``metrics_tpu/obs/profile.py``):
per analysis-registry entry, the step's recorded costs joined with its wall
time.

The JAX package reads XLA's ``cost_analysis()`` off a compiled executable
and collective payload bytes off optimized HLO text. The port has neither
(its steps are eager, captured into CUDA graphs on the card), so each row
is measured by running the entry's step (ROADMAP D66):

- ``collectives`` and ``collective_bytes``: the logical collectives and the
  payload bytes the step sends through the audit's recording communicator
  (``analysis/graph_audit.py::MirrorWorld``, a world of ``ndev``);
- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over one step,
  and ``bytes_accessed``: the sum of the recorded aten ops' input and
  output bytes (views excluded). Both are **the port's model**, not XLA's:
  FlopCounterMode counts matmuls and convolutions only, and neither sees
  a kernel of the port (launched through ``ctypes``);
- ``wall``: p50/p99 through the port's ``LatencyHistogram``, folding on the
  profiled device (``fold_device``, D55); per-ladder-tier wall rows for the
  ladder entries;
- on CUDA, ``device_ms`` (the card's time per step, by CUDA events) and
  ``kernel_launches`` (K1-K3's launches per step, counted by
  ``ops/_build.py::count_launch``).

``python -m metrics_tpu_torch.analysis profile`` runs the registry and
writes the table to the port's own file (:func:`default_profile_path`,
``metrics_tpu_torch/analysis/COST_PROFILE.json``, git-ignored); it never
writes the repo-root ``COST_PROFILE.json``, which is the JAX package's.
"""
import json
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "COST_PROFILE_FILENAME",
    "profile_entry",
    "profile_registry",
    "render_table",
    "write_profile",
    "default_profile_path",
]

COST_PROFILE_FILENAME = "COST_PROFILE.json"

_KERNELS = (
    ("binned_counters", "metrics_tpu_torch.ops.binned_counters"),
    ("histogram", "metrics_tpu_torch.ops.histogram"),
    ("compactor_fold", "metrics_tpu_torch.ops.compactor"),
)


def _kernel_counts() -> Dict[str, int]:
    import importlib

    return {name: importlib.import_module(mod).launch_count for name, mod in _KERNELS}


def _sync(device: Any) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _wall_quantiles(call: Callable[[], Any], reps: int, name: str, device: Any) -> Dict[str, Any]:
    """Drive ``call()`` ``reps`` times (after one warm call) feeding a
    ``LatencyHistogram`` that folds on ``device``; p50/p99 milliseconds."""
    from metrics_tpu_torch.obs.runtime_metrics import LatencyHistogram

    hist = LatencyHistogram(name, device=device)
    call()  # warm: the first update at a key runs eagerly, the second captures
    _sync(device)
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        _sync(device)
        hist.observe((time.perf_counter() - t0) * 1e3)
    qs = hist.quantiles((0.5, 0.99))
    return {"p50_ms": qs[0.5], "p99_ms": qs[0.99], "mean_ms": hist.sum_ms / max(1, hist.count), "reps": hist.count}


def _device_ms(call: Callable[[], Any], reps: int) -> float:
    """The card's time per call, by CUDA events around ``reps`` calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _entry_call(entry: Any, world: Any, device: Any) -> Tuple[Callable, Tuple]:
    """(step, args) for one registry entry: the budget step when it
    exists, else the recompilation target's update at batch 32 (so EVERY entry
    gets a row)."""
    if entry.build is not None:
        return entry.build(world, device)
    if entry.build_recompile is not None:
        target, make_args = entry.build_recompile()
        run = target.fresh(device)
        args, kwargs = make_args(32, device)
        return (lambda: run.update(args, kwargs)), ()
    raise ValueError(f"registry entry {entry.name!r} has no step to profile")  # pragma: no cover


def profile_entry(entry: Any, ndev: int = 4, reps: int = 20, tier_reps: int = 10, device: Any = None) -> Dict[str, Any]:
    """One cost-table row for one registry entry (see the module's
    docstring for each key)."""
    from torch.utils.flop_counter import FlopCounterMode

    from metrics_tpu_torch.analysis.graph_audit import (
        MirrorWorld,
        collective_counts,
        collective_payload_bytes,
        mirrored,
        record_step,
    )
    from metrics_tpu_torch.analysis.registry import resolve_device
    from metrics_tpu_torch.ops.padding import leading_rows

    device = resolve_device(device)
    world = MirrorWorld(ndev)
    step, args = _entry_call(entry, world, device)
    with mirrored(world):
        step(*args)  # the first update at a key runs eagerly (D1)
        _sync(device)
        with FlopCounterMode(display=False) as flops:
            _, trace = record_step(step, args, world=world)
        counts = {op: n for op, n in collective_counts(trace).items() if n}
        payload = {op: b for op, b in collective_payload_bytes(trace).items() if b}
        row: Dict[str, Any] = {
            "entry": entry.name,
            "flops": flops.get_total_flops(),
            "bytes_accessed": trace.bytes_accessed,
            "aten_ops": len(trace.ops),
            "collectives": counts,
            "collective_bytes": payload,
            "collective_bytes_total": sum(payload.values()),
        }
        def call() -> None:
            # a stateful step accumulates over the reps (JAX's starts from
            # init each call): its ring fills and its sketch saturates, and
            # their warnings at compute are the noise of a long run
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                step(*args)

        if device.type == "cuda":
            before = _kernel_counts()
            row["device_ms"] = _device_ms(call, reps)
            after = _kernel_counts()
            row["kernel_launches"] = {k: (after[k] - before[k]) / reps for k in after}
        row["wall"] = _wall_quantiles(call, reps, f"profile_{entry.name}_ms", device)
    sweep = entry.warmup_sizes or entry.sweep_sizes
    if entry.build_recompile is not None and sweep:
        target, make_args = entry.build_recompile()
        run = target.fresh(device)
        tiers: Dict[int, Tuple[tuple, dict]] = {}
        for n in sweep:
            tier_args = make_args(n, device)
            tier = leading_rows(tier_args[0])
            if tier is not None and tier not in tiers:
                tiers[tier] = tier_args
        row["tiers"] = {
            str(tier): _wall_quantiles(
                (lambda a=a, k=k: run.update(a, k)), tier_reps, f"profile_{entry.name}_t{tier}_ms", device
            )
            for tier, (a, k) in sorted(tiers.items())
        }
    return row


def profile_registry(
    entries: Optional[Sequence[Any]] = None,
    ndev: int = 4,
    reps: int = 20,
    tier_reps: int = 10,
    device: Any = None,
) -> Dict[str, Any]:
    """The full cost table: one row per registry entry (default: all of
    ``analysis/registry.py::REGISTRY``), on ``device`` (CUDA by default)."""
    import torch

    from metrics_tpu_torch.analysis.registry import REGISTRY, resolve_device

    device = resolve_device(device)
    rows = [
        profile_entry(entry, ndev=ndev, reps=reps, tier_reps=tier_reps, device=device)
        for entry in (entries if entries is not None else REGISTRY)
    ]
    return {
        "created_unix": time.time(),
        "platform": device.type,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "ndev": ndev,
        "reps": reps,
        "cost_model": "flops: torch.utils.flop_counter.FlopCounterMode; bytes_accessed: sum of the recorded "
        "aten ops' input and output bytes (views excluded); neither sees the port's ctypes kernels",
        "entries": rows,
    }


def _fmt_num(value: Any) -> str:
    if value is None:
        return "-"
    value = float(value)
    for unit, scale in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(value) >= scale:
            return f"{value / scale:.2f}{unit}"
    return f"{value:.0f}"


def render_table(doc: Dict[str, Any]) -> str:
    """The cost table as aligned text (the CLI's stdout form)."""
    header = (
        f"{'entry':<28} {'flops':>9} {'bytes':>9} {'coll-B':>8} "
        f"{'wall p50':>10} {'wall p99':>10} {'device':>9}  tiers(p50 ms)"
    )
    lines: List[str] = [header, "-" * len(header)]
    for row in doc["entries"]:
        wall = row["wall"]
        tiers = row.get("tiers") or {}
        tier_txt = " ".join(
            f"{tier}:{t['p50_ms']:.2f}" for tier, t in sorted(tiers.items(), key=lambda kv: int(kv[0]))
        )
        device = f"{row['device_ms']:.3f}ms" if "device_ms" in row else "-"
        lines.append(
            f"{row['entry']:<28} {_fmt_num(row['flops']):>9} "
            f"{_fmt_num(row['bytes_accessed']):>9} "
            f"{_fmt_num(row['collective_bytes_total']):>8} "
            f"{wall['p50_ms']:>8.3f}ms {wall['p99_ms']:>8.3f}ms {device:>9}  {tier_txt}"
        )
    lines.append(
        f"({len(doc['entries'])} entries, platform={doc['platform']}, ndev={doc['ndev']}, reps={doc['reps']})"
    )
    return "\n".join(lines)


def default_profile_path() -> str:
    """The port's own cost table, ``metrics_tpu_torch/analysis/COST_PROFILE.json``
    (git-ignored; the repo-root file is the JAX package's)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "analysis", COST_PROFILE_FILENAME)


def write_profile(doc: Dict[str, Any], path: Optional[str] = None) -> str:
    """Persist one cost table (atomic — tmp, fsync, rename, so a killed
    profiler never leaves a torn table)."""
    from metrics_tpu_torch.resilience.snapshot import atomic_write_bytes

    path = path or default_profile_path()
    atomic_write_bytes(path, (json.dumps(doc, indent=1, default=str) + "\n").encode())
    return path
