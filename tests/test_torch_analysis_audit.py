"""The port's step-budget audit (``metrics_tpu_torch/analysis/{graph_audit,registry}.py``)
against the JAX package's registry (``metrics_tpu/analysis/registry.py``):
the same entry names in the same order, every entry within its budget on
the CPU, one seeded violation per kind failing with JAX's ``kind`` string,
four entries' collective counts equal to JAX's lowered on 4 devices, and
ROADMAP F14 (the HyperLogLog insert's float64 op, which the audit found).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from metrics_tpu_torch.analysis import graph_audit as G  # noqa: E402
from metrics_tpu_torch.analysis import registry as R  # noqa: E402
from metrics_tpu_torch.analysis.__main__ import main as cli  # noqa: E402

CPU = torch.device("cpu")
BY_NAME = {e.name: e for e in R.REGISTRY}


def test_registry_names_equal_jax():
    from metrics_tpu.analysis.registry import REGISTRY as JAX_REGISTRY

    assert [e.name for e in R.REGISTRY] == [e.name for e in JAX_REGISTRY]


@pytest.mark.parametrize("name", list(BY_NAME))
def test_entry_within_its_budget_on_the_cpu(name):
    report = {}
    assert R.run_graph_audit((BY_NAME[name],), device="cpu", report=report) == []
    row = report[name]
    if "collectives" in row:
        # the update half reads nothing back and shapes nothing by value (D68)
        assert set(row["host_reads"]) <= {"compute"} and set(row["dynamic_shapes"]) <= {"compute"}
        assert row["host_reads"].get("compute", 0) == R.COMPUTE_HOST_READS.get(name, 0)
    if "graphs" in row and row["captured"]:
        assert row["graphs"]["stable"] == {"keys": 1, "captures": 1, "replays": 1}


@pytest.fixture(scope="module")
def jax_counts():
    """JAX's four entries lowered once each on 4 of the 8 virtual CPU
    devices (tests/conftest.py): collective counts, and the fused
    collection's payload bytes."""
    from metrics_tpu.analysis.graph_audit import collective_counts, hlo_of
    from metrics_tpu.analysis.registry import REGISTRY as JAX_REGISTRY
    from metrics_tpu.obs.profile import collective_payload_bytes

    out = {}
    for entry in JAX_REGISTRY:
        if entry.name in ("fused_stat_collection", "guarded_collection", "overlapped_read_step", "auroc_capacity_step"):
            hlo = hlo_of(*_flat(entry.build(4)))
            out[entry.name] = (collective_counts(hlo), collective_payload_bytes(hlo))
    return out


def _flat(built):
    fn, args = built
    return (fn, *args)


@pytest.mark.parametrize("name", ["fused_stat_collection", "guarded_collection", "overlapped_read_step", "auroc_capacity_step"])
def test_collective_counts_equal_jax(name, jax_counts):
    _, _, trace = R.run_entry_step(BY_NAME[name], G.MirrorWorld(4), CPU)
    assert G.collective_counts(trace) == jax_counts[name][0]


def test_fused_collection_payload_bytes_equal_jax(jax_counts):
    """JAX's functionalized collection syncs every member's states, as the
    port's buckets do (D12), so the payload ratio is 1 here: 4 members x
    (tp, fp, tn, fn) x 4 classes + each member's extra state, int32."""
    _, _, trace = R.run_entry_step(BY_NAME["fused_stat_collection"], G.MirrorWorld(4), CPU)
    port = {k: v for k, v in G.collective_payload_bytes(trace).items() if v}
    jax = {k: v for k, v in jax_counts["fused_stat_collection"][1].items() if v}
    assert port == jax


def _trace(step, world=None):
    return G.record_step(step, world=world)[1]


def _three_bucket_sync(world):
    from metrics_tpu_torch.parallel.sync import fused_sync

    states = [{"a": torch.ones(3, dtype=torch.int32), "b": torch.ones(2, dtype=torch.int64), "c": torch.ones(4)}]
    return lambda: fused_sync(states, [{"a": "sum", "b": "sum", "c": "sum"}], None, comm=world)


def test_seeded_third_all_reduce_fails():
    world = G.MirrorWorld(4)
    trace = _trace(_three_bucket_sync(world), world)
    assert G.collective_counts(trace)["all-reduce"] == 3
    (v,) = G.audit_trace(trace, G.GraphBudget(max_all_reduce=2), "seeded")
    assert v.kind == "collective-budget" and "3 all-reduce ops, budget allows 2" in v.detail


@pytest.mark.parametrize(
    "kind,step",
    [
        ("f64", lambda: torch.arange(4.0).double().sum()),
        ("host-callback", lambda: torch.arange(4.0).sum().item()),
        ("dynamic-shape", lambda: torch.arange(4.0).nonzero()),
        ("dynamic-shape", lambda: torch.arange(4.0)[torch.arange(4.0) > 1]),
    ],
)
def test_seeded_op_violation_fails(kind, step):
    violations = G.audit_trace(_trace(step), G.GraphBudget(), "seeded")
    assert [v.kind for v in violations] == [kind]


def test_compute_phase_allowance_never_covers_the_update():
    def step():
        x = torch.arange(4.0)
        with G.audit_phase("update"):
            y = x + 1
        with G.audit_phase("compute"):
            return float(y.sum())

    trace = _trace(step)
    assert G.audit_trace(trace, G.GraphBudget(compute_host_reads=1), "ok") == []
    assert [v.kind for v in G.audit_trace(trace, G.GraphBudget(), "strict")] == ["host-callback"]

    def reads_in_update():
        with G.audit_phase("update"):
            return bool(torch.ones(1))

    assert [v.kind for v in G.audit_trace(_trace(reads_in_update), G.GraphBudget(compute_host_reads=5), "x")] == ["host-callback"]


def test_seeded_batch_dependent_state_shape_fails():
    target = G.PureTarget(lambda device: ((lambda: {"rows": torch.zeros(0)}), (lambda s, v: {"rows": v.clone()})))
    violations = G.audit_recompilation(target, lambda b, d: ((torch.zeros(b),), {}), entry="seeded")
    assert [v.kind for v in violations] == ["recompilation"] and "depend on the batch size" in violations[0].detail


def _unpadded_make_args(batch, device):
    """The ladder entry's requests without the padding: one shape a size."""
    (p, t), _ = R._overlapped_make_args(batch, device)
    return (p, t), {"valid": torch.ones(batch, dtype=torch.bool, device=device)}


def test_seeded_unpadded_sweep_over_max_graphs_fails():
    target = G.StatefulTarget(R._ladder_make)
    report = {}
    violations = G.audit_recompilation(
        target, _unpadded_make_args, entry="seeded", sweep_sizes=R._SWEEP, max_graphs=3, report=report
    )
    assert [v.kind for v in violations] == ["recompilation"] and "graphs keyed for a sweep of 13" in violations[0].detail
    assert report["sweep"]["keys"] == 14  # one per size, and check 2's 4-row batch
    # padded, the same sweep keys exactly len(ladder): 3 passes, 2 fails
    assert G.audit_recompilation(target, R._ladder_make_args, sweep_sizes=R._SWEEP, max_graphs=3) == []
    assert len(G.audit_recompilation(target, R._ladder_make_args, sweep_sizes=R._SWEEP, max_graphs=2)) == 1


def test_seeded_warmup_gap_fails():
    target = G.StatefulTarget(R._ladder_make)
    report = {}
    violations = G.audit_recompilation(
        target, R._ladder_make_args, entry="seeded", sweep_sizes=R._SWEEP, warmup_sizes=(8, 32), report=report
    )
    assert [v.kind for v in violations] == ["recompilation"] and "warmup matrix has a gap" in violations[0].detail
    assert report["warmed"]["new_keys"] == 1


def test_chunked_schedule_folds_into_logical_collectives():
    _, _, trace = R.run_entry_step(BY_NAME["chunked_fused_step"], G.MirrorWorld(4), CPU)
    _, _, whole = R.run_entry_step(BY_NAME["overlapped_fused_step"], G.MirrorWorld(4), CPU)
    assert G.collective_counts(trace) == G.collective_counts(whole)
    assert G.physical_collective_counts(trace)["all-reduce"] == 4 * G.collective_counts(trace)["all-reduce"]
    assert G.collective_payload_bytes(trace) == G.collective_payload_bytes(whole)


def test_quantized_entry_pins_the_uint8_gather():
    """D18/D67: the int8 wire is one all_gather of bytes; no float32 payload
    rides an all_reduce, while the exact twin sends float32 in one."""
    _, _, q = R.run_entry_step(BY_NAME["quantized_fused_step"], G.MirrorWorld(4), CPU)
    _, _, exact = R.run_entry_step(BY_NAME["sketch_guarded_collection"], G.MirrorWorld(4), CPU)
    assert "all-gather u8[" in q.text() and "all-reduce f32[" not in q.text()
    assert "all-reduce f32[" in exact.text() and "all-gather" not in exact.text()
    budget = BY_NAME["quantized_fused_step"].budget
    assert {v.kind for v in G.audit_trace(exact, budget, "exact")} == {"missing-pattern", "forbidden-pattern"}


def test_cli_audit_on_the_cpu_and_refuses_a_missing_card(capsys, monkeypatch):
    assert cli(["audit", "--device", "cpu"]) == 0
    assert "graph-audit: 0 violation(s) across 19 registry entr(y/ies)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.resolve_device(None)


def test_hll_insert_runs_no_float64_op():
    """ROADMAP F14: the HyperLogLog insert counted leading zeros through a
    float64 frexp; the float32 exponent with its carry correction is exact
    over every 32-bit boundary, and the drift fold runs no float64 op."""
    from metrics_tpu_torch.streaming.sketches import HllState, _clz32

    edges = sorted({v for b in range(33) for v in ((1 << b) - 1, 1 << b, (1 << b) + 1) if 1 <= v < 1 << 32})
    w = torch.tensor(edges + list(range(1, 5000)) + [(1 << 32) - k for k in range(1, 500)], dtype=torch.int64)
    want = torch.tensor([32 - int(v).bit_length() for v in w.tolist()])
    assert torch.equal(_clz32(w), want)
    values = torch.from_numpy(np.random.default_rng(7).random(4096).astype(np.float32))
    _, trace = G.record_step(lambda: HllState.create(precision=8, device="cpu").insert(values))
    assert trace.flagged("f64") == []
    assert math.isfinite(float(HllState.create(precision=8, device="cpu").insert(values).estimate()))


def test_mean_update_makes_no_tensor_from_host_data():
    """ROADMAP F15: ``MeanMetric.update``'s default ``weight=1.0`` became a
    tensor copied from the host (``aten.lift_fresh``), which a CUDA-graph
    capture refuses, so every update of the metric ran eagerly on the card
    (the registry's ``mean_update_stability`` captured nothing there). A
    Python number is now filled on the device."""
    import metrics_tpu_torch as mtt

    m = mtt.MeanMetric(device="cpu")
    x = torch.arange(4.0)
    m.update(x)
    _, trace = G.record_step(lambda: m.update(x))
    assert [op.name for op in trace.ops if op.name.startswith("aten.lift_fresh")] == []
    assert float(m.compute()) == 1.5
    assert m._as_float(2.0).device == m._as_float(x).device and float(m._as_float(2.0)) == 2.0


def test_captures_hold_the_cyclic_collector_off():
    """ROADMAP F16: on the card a capture in the registry's audit failed
    (``cudaErrorStreamCaptureInvalidated``) and left its metric eager when
    Python's cyclic collector ran inside it and freed another metric's
    graphs (metrics hold reference cycles through their bound methods). A
    capture now holds the collector off, nested and concurrent holds
    counted, and gives it back as it found it."""
    import gc
    import threading

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch._capture import UpdateGraphs, collector_held

    seen = []

    def capture(run, pool):
        seen.append(gc.isenabled())
        return run

    m = mtt.Accuracy(num_classes=3, device="cpu")
    object.__setattr__(m, "_update_graphs", UpdateGraphs(capture=capture))
    p, t = torch.rand(8, 3), torch.randint(0, 3, (8,))
    assert gc.isenabled()
    for _ in range(3):
        m.update(p, t)
    assert seen == [False] and gc.isenabled() and m._update_graphs.captures == 1

    inside, release = threading.Event(), threading.Event()

    def hold():
        with collector_held():
            inside.set()
            release.wait(10)

    worker = threading.Thread(target=hold, daemon=True, name="holder")
    worker.start()
    assert inside.wait(10)
    with collector_held():
        assert not gc.isenabled()
    assert not gc.isenabled()  # the other capture still holds it
    release.set()
    worker.join(10)
    assert gc.isenabled()
    gc.disable()
    try:
        with collector_held():
            pass
        assert not gc.isenabled()  # off before, off after
    finally:
        gc.enable()
