"""The traced run's profiler windows and what is read from them.

A traced run profiles segments of its first epochs with ``torch.profiler``
(CPU and CUDA activity). A segment runs from an epoch's third update to the
end of that epoch's ``reset()``: the first two updates after a ``reset()``
run eagerly and capture the update's CUDA graph, which the harness keeps
out of the profiler (it drains the queue before it starts the profiler).
A segment keeps the index of its first update in the epoch
(``first_batch``), so that the work of its updates can be counted. The
harness marks what the host is doing with
``torch.profiler.record_function`` ranges named ``bench.update``,
``bench.drain``, ``bench.compute`` and ``bench.reset``; the card's records
(kernels, copies, memsets) carry times in the same clock.

:func:`summarize` reduces the segments to the numbers the per-layer readers
and the ``breakdown`` take. It reads plain tuples, so it is tested without a
card.
"""
from typing import Any, Dict, List, Tuple

from benchmark.harness.roofline import kernel_of

RANGE_PREFIX = "bench."
TOP = 10  # entries of each list of the breakdown
NAME_CHARS = 200  # a device operation's name in the breakdown, cut to this


def segment_records(prof: Any, first_batch: int) -> Dict[str, Any]:
    """``{"device": [(name, start_us, end_us)], "ranges": [(phase, start_us,
    end_us)], "first_batch": first_batch}`` of one finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, ranges = [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.name.startswith(RANGE_PREFIX):
            # a range also shows on the card's timeline as an annotation: only the host's counts
            if e.device_type != DeviceType.CUDA:
                ranges.append((e.name[len(RANGE_PREFIX):], start, end))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, start, end))
    return {"device": device, "ranges": sorted(ranges, key=lambda r: r[1]), "first_batch": first_batch}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _phase_at(ranges: List[Tuple[str, float, float]], lo: float, hi: float) -> List[Tuple[str, float]]:
    """``[(phase, us)]`` of the host's ranges over ``[lo, hi)``; time that no
    range covers is the loop's."""
    out, covered = [], 0.0
    for phase, a, b in ranges:
        overlap = min(hi, b) - max(lo, a)
        if overlap > 0:
            out.append((phase, overlap))
            covered += overlap
    if hi - lo - covered > 0:
        out.append(("loop", hi - lo - covered))
    return out


def summarize(segments: List[Dict[str, Any]], kernels: Dict[str, Tuple[str, ...]]) -> Dict[str, Any]:
    """Totals over the segments (seconds): the window, the card's busy time,
    the time of each of the port's ``kernels`` (``{key: parts of its
    names}``), the torch ops' device time inside the updates (from an
    epoch's first traced update to the end of its drain), the updates
    traced, the device operations by time and the idle time by what the
    host was doing."""
    window = busy = torch_ops = 0.0
    updates = 0
    kernel_s: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    for seg in segments:
        ranges = seg["ranges"]
        if not ranges:
            continue
        lo, hi = ranges[0][1], max(r[2] for r in ranges)
        window += (hi - lo) / 1e6
        update_ranges = [r for r in ranges if r[0] == "update"]
        updates += len(update_ranges)
        drains = [r for r in ranges if r[0] == "drain"]
        work_lo = update_ranges[0][1] if update_ranges else hi
        work_hi = drains[-1][2] if drains else hi
        inside = []
        for name, a, b in seg["device"]:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            inside.append((a, b))
            ops[name[:NAME_CHARS]] = ops.get(name[:NAME_CHARS], 0.0) + (b - a) / 1e6
            kernel = kernel_of(name, kernels)
            if kernel is not None:
                kernel_s[kernel] = kernel_s.get(kernel, 0.0) + (b - a) / 1e6
            elif work_lo <= a < work_hi:
                torch_ops += (b - a) / 1e6
        merged = _union(inside)
        busy += sum(b - a for a, b in merged) / 1e6
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for gap_lo, gap_hi in zip(edges[0::2], edges[1::2]):
            if gap_hi > gap_lo:
                for phase, us in _phase_at(ranges, gap_lo, gap_hi):
                    idle[phase] = idle.get(phase, 0.0) + us / 1e6
    return {
        "window_s": window, "busy_s": busy, "updates": updates, "torch_ops_s": torch_ops,
        "kernel_s": kernel_s,
        "device_ops": sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([p, s] for p, s in idle.items()), key=lambda x: -x[1])[:TOP],
    }
