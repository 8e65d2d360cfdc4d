"""The evaluation loop that the window drives, as a user's loop runs it.

An epoch hands every batch to ``MetricCollection.update`` with no
synchronisation between updates, then drains the queue, calls
``compute()``, reads the values to the host as a user logs them, and calls
``reset()``. A CUDA event is recorded on the card's stream just before and
just after each ``update()`` call; the events are read after the window.
The window holds whole epochs: it ends with the first epoch that ends past
``seconds``.

A traced run also keeps the host's time of each ``update()`` call, counts
the members' updates and graph replays, and profiles segments of its first
epochs (``profiling.py``).
"""
import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from benchmark.harness import program
from benchmark.harness.profiling import RANGE_PREFIX, segment_records

Tensor = torch.Tensor

# updates of an epoch before its profiled segment starts: the eager update
# and the capture that follow each reset() (profiling.py)
PROFILE_SKIP = 2
PROFILE_S = 0.25  # epochs are profiled until their segments (profiler start to stop) took this long
PROFILE_MAX_EPOCHS = 20


class SpanClock:
    """Pairs of marks around each update: CUDA events on the card (made
    ahead, read after the window), the host clock on the CPU."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        self.spare: List[Tuple[Any, Any]] = []
        self.used: List[Tuple[Any, Any]] = []

    def reserve(self, pairs: int) -> None:
        if self.cuda:
            self.spare += [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(pairs)]

    def start(self) -> Any:
        if not self.cuda:
            return [time.perf_counter(), None]
        pair = self.spare.pop() if self.spare else (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        return pair

    def stop(self, pair: Any) -> None:
        if self.cuda:
            pair[1].record()
        else:
            pair[1] = time.perf_counter()
        self.used.append(pair)

    def spans_ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.used]
        return [(b - a) * 1e3 for a, b in self.used]


def to_host(value: Any) -> Any:
    """The computed values in the same structure, each tensor a NumPy float64
    array, read from the card with one concatenation and one copy a dtype
    (a list of a thousand per-class values is not a thousand reads)."""
    leaves, layout = tree_flatten(value)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(leaves):
        if isinstance(x, Tensor):
            by_dtype.setdefault(x.dtype, []).append(i)
    out = list(leaves)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx]).cpu().numpy().astype(np.float64)
        at = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[at:at + n].reshape(tuple(leaves[i].shape))
            at += n
    return tree_unflatten(out, layout)


@dataclass
class Window:
    epochs: int = 0
    rows: int = 0
    seconds: float = 0.0
    update_ms: List[float] = field(default_factory=list)
    compute_s: List[float] = field(default_factory=list)
    values: List[Any] = field(default_factory=list)
    host_update_s: List[float] = field(default_factory=list)
    member_updates: int = 0
    replays: int = 0
    segments: List[Any] = field(default_factory=list)


class Loop:
    """The collection and its inputs, and the epochs it runs."""

    def __init__(self, collection: Any, inputs: Any, device: Any, trace: bool) -> None:
        self.collection = collection
        self.device = torch.device(device)
        self.trace = trace
        self.batches = [inputs.batch(i) for i in range(len(inputs.batches))]
        self.rows = inputs.rows
        self.clock = SpanClock(self.device)
        self.first_traced = min(PROFILE_SKIP, len(self.batches) - 1)  # an epoch's first profiled update

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self) -> Any:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.start()
        return prof

    def epoch(self, win: Optional[Window], profile: bool = False) -> float:
        """One epoch; with ``win`` its spans and values are kept there.
        Returns the seconds of its profiled segment (0 without one)."""
        coll, trace = self.collection, self.trace and win is not None
        prof, seg_t0 = None, 0.0
        mark = (lambda phase: torch.profiler.record_function(RANGE_PREFIX + phase)) if profile else (lambda phase: contextlib.nullcontext())
        for i, (args, kwargs) in enumerate(self.batches):
            if profile and i == self.first_traced:
                self._sync()  # the eager update's and the capture's work stays out
                prof = self._profiler()
                seg_t0 = time.perf_counter()
            with mark("update") if prof is not None else contextlib.nullcontext():
                pair = self.clock.start() if win is not None else None
                h0 = time.perf_counter()
                coll.update(*args, **kwargs)
                h1 = time.perf_counter()
                if pair is not None:
                    self.clock.stop(pair)
            if trace:
                win.host_update_s.append(h1 - h0)
        with mark("drain"):
            self._sync()
        with mark("compute"):
            c0 = time.perf_counter()
            values = to_host(coll.compute())
            c1 = time.perf_counter()
        if trace:
            win.member_updates += program.member_updates(coll)
        with mark("reset"):
            coll.reset()
        seg_s = 0.0
        if prof is not None:
            self._sync()
            seg_s = time.perf_counter() - seg_t0
            prof.stop()
            win.segments.append((prof, self.first_traced))  # read after the window
        if win is not None:
            win.compute_s.append(c1 - c0)
            win.values.append(values)
        return seg_s

    def warm(self, seconds: float) -> None:
        """One untimed epoch: it loads the kernels and meets every shape; then
        the events of a window of ``seconds`` are made ahead."""
        t0 = time.perf_counter()
        self.epoch(None)
        self._sync()
        epoch_s = time.perf_counter() - t0
        self.clock.reserve(int(1.5 * seconds / max(epoch_s, 1e-4) + 2) * len(self.batches))
        # what set-up left behind is collected once and kept out of every
        # later collection: a full collection of the whole heap (torch's
        # modules, the inputs) would otherwise stall some update or compute()
        gc.collect()
        gc.freeze()

    def window(self, seconds: float) -> Window:
        win = Window()
        replays0 = program.graph_replays(self.collection) if self.trace else 0
        profiled = 0.0
        t0 = time.perf_counter()
        while True:
            profile = self.trace and win.epochs < PROFILE_MAX_EPOCHS and profiled < PROFILE_S
            profiled += self.epoch(win, profile=profile)
            win.epochs += 1
            if time.perf_counter() - t0 >= seconds:
                break
        win.seconds = time.perf_counter() - t0
        win.rows = win.epochs * self.rows
        if self.trace:
            win.replays = program.graph_replays(self.collection) - replays0
        win.update_ms = self.clock.spans_ms()
        win.segments = [segment_records(prof, first) for prof, first in win.segments]
        return win
