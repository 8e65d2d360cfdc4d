"""``ServeLoop`` and the warmup of the port (``metrics_tpu_torch/serving/``)
on the CPU: the JAX package's serving cases, the same seeded requests through
both packages' loops, shedding on a full queue, the refusals of misuse and
of what is left out (the fleet methods), and the warmup's captures with a
stand-in capture step (nothing is captured on the CPU). Snapshots, drift
and scrape are in ``tests/test_torch_serving_obs.py``."""
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.ops import padding as jpadding  # noqa: E402
from metrics_tpu_torch._capture import UpdateGraphs  # noqa: E402
from metrics_tpu_torch.ops import padding  # noqa: E402
from metrics_tpu_torch.resilience.health import health_report, registry  # noqa: E402
from metrics_tpu_torch.serving import Warmup, WarmupEngine, configure_compile_cache, warmup_enabled  # noqa: E402
from metrics_tpu_torch.serving import loop as loop_mod  # noqa: E402
from metrics_tpu_torch.serving import warmup as warmup_mod  # noqa: E402
from metrics_tpu_torch.serving.warmup import reset_warmup_state  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402

C = 4


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """A clean health registry and a one-tier ladder of 16 rows, in both
    packages."""
    monkeypatch.setenv("METRICS_TPU_PAD_LADDER", "16")
    padding.reset_padding_state()
    jpadding.reset_padding_state()
    reset_warmup_state()
    registry.clear()
    yield
    registry.clear()
    padding.reset_padding_state()
    jpadding.reset_padding_state()
    reset_warmup_state()


def _batch(rng, n, classes=C):
    return (
        torch.from_numpy(rng.random((n, classes)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, classes, n).astype(np.int32)),
    )


def _acc(**kw):
    return mtt.Accuracy(num_classes=C, pad_batches=True, device="cpu", **kw)


def test_offers_drain_and_report_reconciles():
    rng = np.random.default_rng(0)
    with mtt.ServeLoop(_acc(), workers=2) as loop:
        ref = mtt.Accuracy(num_classes=C, device="cpu")
        for _ in range(12):
            p, t = _batch(rng, int(rng.integers(1, 17)))
            assert loop.offer(p, t)
            ref.update(p, t)
        assert loop.drain(30)
        loop.stop()
        view = loop.report()
    assert view["stats"]["offered"] == 12
    assert view["stats"]["accepted"] + view["stats"]["shed"] == view["stats"]["offered"]
    assert view["stats"]["processed"] == 12
    assert view["updates"] == 12
    assert float(view["value"]) == float(ref.compute())


def test_report_never_blocks_and_serves_stale_view():
    with mtt.ServeLoop(_acc(), workers=1, reduce_every_s=600.0) as loop:
        rng = np.random.default_rng(1)
        loop.offer(*_batch(rng, 8))
        assert loop.drain(30)
        t0 = time.monotonic()
        view = loop.report()
        assert time.monotonic() - t0 < 1.0
        assert not view["fresh"]
        view = loop.report(fresh=True, deadline_s=30.0)
        assert view["fresh"]
        assert view["updates"] == 1
        assert view["staleness_s"] is not None
        loop.stop()


def test_fresh_deadline_miss_degrades_to_stale_view():
    with mtt.ServeLoop(_acc(), workers=1, reduce_every_s=600.0) as loop:
        view = loop.report(fresh=True, deadline_s=0.0)
        assert not view["fresh"]
        assert view["value"] is None
        loop.stop()


def test_offer_after_stop_raises():
    loop = mtt.ServeLoop(_acc(), workers=1)
    loop.stop()
    with pytest.raises(MetricsTPUUserError, match="after stop"):
        loop.offer(torch.zeros((4, C)), torch.zeros((4,), dtype=torch.int32))


def test_worker_survives_poison_request():
    rng = np.random.default_rng(2)
    with mtt.ServeLoop(_acc(), workers=1) as loop:
        p, t = _batch(rng, 8)
        loop.offer(p, t)
        loop.offer("not-an-array")
        loop.offer(p, t)
        assert loop.drain(30)
        loop.stop()
        view = loop.report()
    assert view["stats"]["failed"] == 1
    assert view["updates"] == 2
    assert registry.counts().get("serve_update_error") == 1


def test_poison_request_rolls_back_inferred_mode():
    rng = np.random.default_rng(7)
    with mtt.ServeLoop(_acc(top_k=1), workers=1) as loop:
        # multilabel-shaped: the mode is inferred, then top_k refuses it
        loop.offer(
            torch.from_numpy(rng.random((8, C)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (8, C)).astype(np.int32)),
        )
        p, t = _batch(rng, 8)
        loop.offer(p, t)
        assert loop.drain(30)
        loop.stop()
        view = loop.report()
    assert view["stats"]["failed"] == 1
    ref = mtt.Accuracy(num_classes=C, top_k=1, device="cpu")
    ref.update(p, t)
    assert view["updates"] == 1
    assert float(view["value"]) == float(ref.compute())


def test_overload_sheds_loudly_and_reconciles():
    """A one-slot queue flooded: the shed requests are counted and recorded,
    and ``accepted + shed == offered``."""
    rng = np.random.default_rng(3)
    loop = mtt.ServeLoop(_acc(), workers=1, queue_size=1)
    p, t = _batch(rng, 16)
    for _ in range(200):
        loop.offer(p, t)
    loop.stop()
    stats = loop.stats()
    assert stats["shed"] > 0
    assert stats["accepted"] + stats["shed"] == stats["offered"] == 200
    assert stats["processed"] == stats["accepted"]
    assert registry.counts()["overload_shed"] == stats["shed"]
    rep = loop.health()
    assert rep["degraded"] is True
    assert rep["serving"]["shed"] == stats["shed"]
    assert loop.report()["updates"] == stats["accepted"]


class _SlowMean(mtt.MeanMetric):
    def update(self, value, weight=1.0):  # noqa: D102
        time.sleep(0.02)
        super().update(value, weight)


def test_stop_without_drain_reduces_every_processed_batch():
    loop = mtt.ServeLoop(_SlowMean(device="cpu"), workers=1, queue_size=64, reduce_every_s=600.0)
    for v in range(20):
        assert loop.offer(torch.tensor([float(v)]))
    loop.stop(drain=False, timeout_s=30.0)
    stats = loop.stats()
    assert stats["processed"] == stats["accepted"] == 20
    view = loop.report()
    assert view["updates"] == 20
    np.testing.assert_allclose(float(view["value"]), sum(range(20)) / 20.0, rtol=1e-6)


def test_fresh_report_after_stop_short_circuits():
    loop = mtt.ServeLoop(_acc(), workers=1)
    loop.stop()
    t0 = time.monotonic()
    view = loop.report(fresh=True, deadline_s=5.0)
    assert time.monotonic() - t0 < 1.0
    assert view["value"] is None


def test_multithread_ragged_fault_stress_matches_single_thread_reference():
    """Three client threads fire ragged batches with NaN and out-of-range
    rows at a guarded, windowed collection behind a small queue: the merged
    value equals a single-thread reference over the accepted clean rows,
    and the fault counts account for every accepted injected row."""
    clients, batches, window = 3, 12, 4096

    def coll(**guard):
        return mtt.MetricCollection({
            "acc": mtt.Accuracy(num_classes=C, device="cpu", **guard),
            "win": mtt.WindowedMetric(mtt.Accuracy(num_classes=C, device="cpu", **guard), window=window, buckets=2, **(
                {"pad_batches": True} if guard else {})),
        })

    loop = mtt.ServeLoop(coll(on_invalid="drop", pad_batches=True), workers=3, queue_size=4)
    lock = threading.Lock()
    accepted = []

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(batches):
            n = int(rng.integers(4, 17))
            p, t = _batch(rng, n)
            rows = rng.permutation(n)
            nan_rows, label_rows = rows[:2], rows[2:3]
            bad_p, bad_t = p.clone(), t.clone()
            bad_p[torch.from_numpy(nan_rows)] = float("nan")
            bad_t[torch.from_numpy(label_rows)] = C
            if loop.offer(bad_p, bad_t):
                keep = np.ones(n, bool)
                keep[nan_rows] = False
                keep[label_rows] = False
                with lock:
                    accepted.append((p, t, torch.from_numpy(keep)))

    threads = [threading.Thread(target=client, args=(1000 + i,)) for i in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert loop.drain(60)
    loop.stop()
    stats = loop.stats()
    assert stats["accepted"] + stats["shed"] == stats["offered"] == clients * batches
    assert stats["failed"] == 0
    ref = coll()
    for p, t, keep in accepted:
        ref.update(p[keep], t[keep])
    want = ref.compute()
    view = loop.report()
    for key in ("acc", "win"):
        assert float(view["value"][key]) == float(want[key]), key
    n_bad = 3 * len(accepted)
    assert view["faults"]["acc"]["nonfinite_preds"] == 2 * len(accepted)
    assert view["faults"]["acc"]["label_out_of_range"] == len(accepted)
    assert view["faults"]["acc"]["dropped_rows"] == n_bad


def test_same_requests_through_both_packages():
    """The same seeded requests through JAX's ServeLoop and the port's: the
    values and the fault counts after ``drain()`` and ``report(fresh=True)``
    are equal and the counts reconcile."""
    rng = np.random.default_rng(11)
    requests = []
    for _ in range(10):
        n = int(rng.integers(1, 17))
        p = rng.random((n, C)).astype(np.float32)
        p[0, 0] = np.nan
        t = rng.integers(0, C, n).astype(np.int32)
        requests.append((p, t))

    def serve(pkg, to_array, **dev):
        proto = pkg.MetricCollection({
            "acc": pkg.Accuracy(num_classes=C, on_invalid="drop", pad_batches=True, **dev),
            "macro": pkg.Accuracy(num_classes=C, average="macro", on_invalid="drop", pad_batches=True, **dev),
        })
        with pkg.ServeLoop(proto, workers=2) as loop:
            for p, t in requests:
                assert loop.offer(to_array(p), to_array(t))
            assert loop.drain(120)
            view = loop.report(fresh=True, deadline_s=120)
        return view

    tv = serve(mtt, torch.from_numpy, device="cpu")
    jv = serve(mt, jnp.asarray)
    assert tv["fresh"] and jv["fresh"]
    for k in ("offered", "accepted", "shed", "processed", "failed"):
        assert tv["stats"][k] == jv["stats"][k]
    assert tv["updates"] == jv["updates"] == 2 * len(requests)
    assert float(tv["value"]["acc"]) == float(jv["value"]["acc"])
    np.testing.assert_allclose(float(tv["value"]["macro"]), float(jv["value"]["macro"]), atol=1e-6)
    assert tv["faults"] == {k: dict(v) for k, v in jv["faults"].items()}


class _Named:
    def __init__(self, name):
        self.name = name

    def check(self):
        return {}


@pytest.mark.parametrize(
    "kwargs, error, match",
    [
        ({"snapshot_every_s": 1.0}, ValueError, "needs a `snapshot_manager`"),
        ({"drift_monitors": [object()]}, MetricsTPUUserError, "must be DriftMonitor"),
        ({"drift_monitors": {"a": _Named("b")}}, MetricsTPUUserError, "!= monitor.name"),
    ],
)
def test_left_out_arguments_are_refused(kwargs, error, match):
    """Misused snapshot and drift arguments are refused (the arguments
    themselves are served since the resilience and observability slice)."""
    with pytest.raises(error, match=match):
        mtt.ServeLoop(_acc(), workers=1, **kwargs)


@pytest.mark.parametrize(
    "method, args, match",
    [("save_snapshot", (), "no snapshot_manager"), ("restore_snapshot", (), "no snapshot_manager"),
     ("scrape", ("xml",), "`fmt` must be"),
     ("fleet_view", (), "item 16"), ("fleet_trace_context", (), "item 16"), ("fleet_extra", (), "item 16")],
)
def test_left_out_methods_are_refused(method, args, match):
    """The fleet methods are left out until item 16; a loop without a
    snapshot manager refuses to snapshot, and ``scrape`` an unknown
    format."""
    with mtt.ServeLoop(_acc(), workers=1) as loop:
        with pytest.raises(MetricsTPUUserError, match=match):
            getattr(loop, method)(*args)


def test_warmup_spec_tiers_and_args():
    spec = Warmup(example_args=(np.zeros((16, C), np.float32), np.arange(16, dtype=np.int32) % C), max_rows=40, ladder=(8, 32, 64))
    assert spec.tiers() == (8, 32, 64)
    args, kwargs = spec.tier_args(32)
    assert args[0].shape == (32, C) and args[0].dtype == np.float32
    assert args[1].shape == (32,) and list(args[1][:20]) == list(np.resize(np.arange(16) % C, 20))
    assert kwargs == {}
    with pytest.raises(ValueError):
        Warmup(example_args=())
    with pytest.raises(TypeError):
        WarmupEngine(_acc(), object())


def test_warmup_on_the_cpu_skips_every_member():
    """Nothing is captured on the CPU: every entry counts as skipped (each
    member's tier and its compute), and the engine reaches ``done``."""
    proto = mtt.MetricCollection({"a": _acc(on_invalid="drop"), "m": mtt.MeanMetric(device="cpu")})
    spec = Warmup(example_args=(np.zeros((16, C), np.float32),), max_rows=16)
    with mtt.ServeLoop(proto, workers=2, warmup=spec) as loop:
        assert loop.wait_warmup(30)
        state = loop.health()["serving"]["warmup"]
    assert state["status"] == "done"
    assert state["graphs_captured"] == 0
    assert state["graphs_skipped"] == 2 * (1 + 1 + 1 + 1)  # replicas x (a's tier + compute, m's shape + compute)
    assert registry.counts().get("serve_warmup_done") == 1
    assert health_report()["degraded"] is False


@pytest.fixture
def stand_in_capture(monkeypatch):
    """Capture on the CPU with the stand-in step: each replica's members
    get a table that records each capture and replays the body eagerly."""
    calls = []

    def capture(run, pool):
        calls.append(threading.current_thread().name)
        return run

    clone = loop_mod._clone

    def cloned(obj):
        new = clone(obj)
        for _, m in loop_mod._members(new):
            object.__setattr__(m, "_update_graphs", UpdateGraphs(capture=capture))
        return new

    monkeypatch.setattr(loop_mod, "_clone", cloned)
    monkeypatch.setattr(warmup_mod, "_captures", lambda m: m._can_jit_update() and not m.debug_checks)
    return calls


def test_warmup_captures_every_replica_member_and_tier(stand_in_capture, monkeypatch):
    """One capture per replica x member x tier, on the warmup thread, largest
    tier first; after ``wait_warmup()`` no request captures, and the served
    value equals the eager reference."""
    monkeypatch.setenv("METRICS_TPU_PAD_LADDER", "8,32")
    padding.reset_padding_state()
    proto = mtt.MetricCollection({"acc1": _acc(on_invalid="drop"), "acc2": _acc(on_invalid="drop", top_k=2)})
    rng = np.random.default_rng(5)
    example = _batch(rng, 32)
    with mtt.ServeLoop(proto, workers=2, warmup=Warmup(example_args=[a.numpy() for a in example])) as loop:
        assert loop.wait_warmup(30)
        state = loop.health()["serving"]["warmup"]
        assert state["status"] == "done" and state["graphs_captured"] == 2 * 2 * 2
        assert set(stand_in_capture) == {"serve-warmup-MetricCollection"}
        warmed = len(stand_in_capture)
        ref = mtt.MetricCollection({"acc1": mtt.Accuracy(num_classes=C, device="cpu"), "acc2": mtt.Accuracy(num_classes=C, top_k=2, device="cpu")})
        for _ in range(16):
            p, t = _batch(rng, int(rng.integers(1, 33)))
            assert loop.offer(p, t)
            ref.update(p, t)
        assert loop.drain(30)
        view = loop.report(fresh=True, deadline_s=30)
        assert len(stand_in_capture) == warmed  # no capture on the request path
        replays = sum(m._update_graphs.replays for r in loop._replicas for _, m in r.items(keep_base=True, copy_state=False))
        assert replays == 2 * 16
    want = ref.compute()
    for k in want:
        assert float(view["value"][k]) == float(want[k])


def test_warmup_failure_never_blocks_serving(stand_in_capture):
    proto = _acc(on_invalid="drop")
    bad = Warmup(example_args=(np.zeros((16, C, 2, 2), np.float32),), max_rows=8)
    rng = np.random.default_rng(6)
    with mtt.ServeLoop(proto, workers=2, warmup=bad) as loop:
        assert loop.wait_warmup(timeout_s=30)
        state = loop.health()["serving"]["warmup"]
        assert state["status"] == "failed" and "error" in state
        assert registry.counts().get("serve_warmup_error") == 1
        assert loop.offer(*_batch(rng, 6))
        assert loop.drain(30)
        view = loop.report(fresh=True, deadline_s=30)
        assert view["value"] is not None and view["stats"]["failed"] == 0


def test_no_warmup_health_reads_none():
    with mtt.ServeLoop(_acc(), workers=1) as loop:
        assert loop.health()["serving"]["warmup"] is None
        assert loop.wait_warmup(1) is False


def test_warmup_env_gate(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_WARMUP", "0")
    reset_warmup_state()
    assert warmup_enabled() is False
    spec = Warmup(example_args=(np.zeros((16, C), np.float32),), max_rows=8)
    with mtt.ServeLoop(_acc(on_invalid="drop"), workers=1, warmup=spec) as loop:
        assert loop._warmup is None
        assert loop.wait_warmup(timeout_s=1) is False


def test_warmup_env_malformed_warns_once_and_stays_on(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_WARMUP", "bananas")
    reset_warmup_state()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert warmup_enabled() is True
        assert warmup_enabled() is True
    assert len([w for w in seen if "METRICS_TPU_WARMUP" in str(w.message)]) == 1


def test_no_persistent_compile_cache(monkeypatch, tmp_path):
    """A CUDA graph cannot outlive its process: the cache directory has no
    effect and says so once."""
    assert configure_compile_cache() is None
    monkeypatch.setenv("METRICS_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    reset_warmup_state()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert configure_compile_cache() is None
        assert configure_compile_cache() is None
    assert len([w for w in seen if "METRICS_TPU_COMPILE_CACHE_DIR" in str(w.message)]) == 1
    assert not any(tmp_path.iterdir())


def test_quantized_transport_syncs_the_reporter(monkeypatch):
    """With ``sync_transport`` set in a multi-process world the reducer syncs
    the reporter's states once itself (float leaves of 64 lanes or more on
    that wire), and its ``compute()`` then syncs nothing (a fake world whose
    other rank holds the same state: the sum doubles)."""
    from metrics_tpu_torch.parallel import sync as sync_mod
    from tests.helpers.torch_twin_world import TwinWorld

    world = TwinWorld()
    monkeypatch.setattr(sync_mod, "distributed_available", lambda: True)
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(256,)).astype(np.float32))
    with mtt.ServeLoop(mtt.SumMetric(dist_sync_fn=world, device="cpu"), workers=1, sync_transport="int8") as loop:
        assert loop.offer(x)
        assert loop.drain(30)
        view = loop.report(fresh=True, deadline_s=30)
    np.testing.assert_allclose(float(view["value"]), 2 * float(x.sum()), rtol=1e-2)
    # the reporter is a clone: its communicator is a copy of the fake world,
    # which carried the sync (a scalar state stays on the exact lanes)
    assert loop._last_reporter.dist_sync_fn.calls and world.calls == []
