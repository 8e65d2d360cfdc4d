"""A run on a broken timed path comes out not correct: the harness is driven
on the CPU at tiny sizes (the look for a card skipped) with the port's
collection broken underneath, once for each fault a cell of one chip can
have, and ``correct`` must read false. The lower-precision control, in the
program's place, must fail at least one of each cell's numbers."""
import time

import pytest
import torch

import metrics_tpu_torch as mtt
from bench_helpers import WORKLOADS, tiny_copy
from benchmark import run
from benchmark.harness import inputs as inputs_mod
from benchmark.harness import judge, program, spec

SEED = 2 ** 31 + 77


def _alter_first(value):
    """``value`` with its first tensor moved by 0.01."""
    if isinstance(value, torch.Tensor):
        return value + 0.01
    if isinstance(value, dict):
        key = next(iter(value))
        return {**value, key: _alter_first(value[key])}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(_alter_first(value[0]), *value[1:])
    if isinstance(value, list):
        return [_alter_first(value[0])] + list(value[1:])
    raise TypeError(type(value))


def _half(args, kwargs):
    n = args[0].shape[0] // 2
    return tuple(a[:n] for a in args), {k: v[:n] for k, v in kwargs.items()}


def _every_other_unchanged(update):
    calls = [0]

    def broken(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] % 2:
            update(self, *args, **kwargs)

    return broken


FAULTS = {
    # every other step returns its state unchanged
    "unchanged": _every_other_unchanged,
    # half of the batch left out, the values taken over the rest
    "half_batch": lambda update: (lambda self, *a, **k: update(self, *_half(a, k)[0], **_half(a, k)[1])),
}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["altered_answer"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_path_is_not_correct(workload, fault, tmp_path, monkeypatch):
    root = tiny_copy(tmp_path)
    cell = spec.load_cell(workload, root, root / "benchmark")
    sound, _, _ = run.run_cell(cell, SEED, 0.05, False, "cpu", time.perf_counter())
    assert sound["correct"] is True
    if fault == "altered_answer":
        compute = mtt.MetricCollection.compute
        monkeypatch.setattr(mtt.MetricCollection, "compute", lambda self: _alter_first(compute(self)))
    else:
        monkeypatch.setattr(mtt.MetricCollection, "update", FAULTS[fault](mtt.MetricCollection.update))
    broken, lines, _ = run.run_cell(cell, SEED, 0.05, False, "cpu", time.perf_counter())
    assert broken["correct"] is False and broken["failed"] == broken["attempted"] > 0
    assert any(c["value"] > c["limit"] for c in broken["checks"].values()), lines


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_a_number_at_a_small_size(workload, tmp_path):
    root = tiny_copy(tmp_path)
    cell = spec.load_cell(workload, root, root / "benchmark")
    members = program.member_specs(cell.config, cell.traffic)
    data = inputs_mod.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    ref = cell.reference()
    got = judge.gaps(ref.expected(data, members), ref.expected(data, members, control=True))
    assert any(v > cell.limits[k] for k, v in got.items()), got
