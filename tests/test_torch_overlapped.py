"""The port's overlapped sync (``metrics_tpu_torch/parallel/async_sync.py``,
``Metric(sync_mode="overlapped")``, ``MetricCollection``) against the JAX
package's, in the cases of ``tests/async_sync/test_scheduler.py``,
``test_overlapped_metric.py`` and ``test_transport_overlapped.py`` (less
those that need ``snapshot_state`` or ``ServeLoop``, not ported yet).

The scheduler cases run through both packages' schedulers. The metric
cases run a JAX metric and its port over the same seeded numpy batches in
the same simulated world of two ranks whose other rank holds the same
state: JAX through ``_pad_gather_trim`` over a stacking gather, the port
through ``tests/helpers/torch_twin_world.py::TwinWorld``. Counts and
accuracy are compared exactly; with the int8 transport the views' states
are compared bit for bit (both packages quantize the same leaves with the
same codec and add the decoded rows in rank order).
"""
import contextlib
import pickle
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu import metric as jax_metric_mod  # noqa: E402
from metrics_tpu.parallel import async_sync as jax_async  # noqa: E402
from metrics_tpu.parallel.sync import _pad_gather_trim as jax_pad_gather_trim  # noqa: E402
from metrics_tpu.resilience.health import registry as jax_registry  # noqa: E402
from metrics_tpu_torch import collections as coll_mod  # noqa: E402
from metrics_tpu_torch import metric as metric_mod  # noqa: E402
from metrics_tpu_torch.ops import quantize as tq  # noqa: E402
from metrics_tpu_torch.parallel import async_sync as port_async  # noqa: E402
from metrics_tpu_torch.parallel import sync as sync_mod  # noqa: E402
from metrics_tpu_torch.resilience.health import health_report, registry  # noqa: E402
from tests.helpers.torch_thread_world import ThreadWorld  # noqa: E402
from tests.helpers.torch_twin_world import TwinWorld  # noqa: E402

SCHEDULERS = {"port": port_async, "jax": jax_async}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("METRICS_TPU_SYNC_EVERY_N", "METRICS_TPU_SYNC_EVERY_S", "METRICS_TPU_SYNC_TRANSPORT"):
        monkeypatch.delenv(var, raising=False)
    port_async.reset_async_sync_state()
    jax_async.reset_async_sync_state()
    tq.reset_transport_env_state()
    registry.clear()
    jax_registry.clear()
    yield
    registry.clear()
    jax_registry.clear()


@pytest.fixture()
def two_ranks(monkeypatch):
    """Both packages see a world of two processes."""
    monkeypatch.setattr(metric_mod, "distributed_available", lambda: True)
    monkeypatch.setattr(coll_mod, "distributed_available", lambda: True)
    monkeypatch.setattr(jax_metric_mod, "distributed_available", lambda: True)


def jax_two_rank_gather(x, group=None, transport=None):
    return jax_pad_gather_trim(x, lambda a: np.stack([np.asarray(a), np.asarray(a)]))


def _batches(seed, n_batches, rows, classes=4):
    rng = np.random.default_rng(seed)
    return [(rng.random((rows, classes)).astype(np.float32), rng.integers(0, classes, rows).astype(np.int32)) for _ in range(n_batches)]


def _j(batch):
    return tuple(jnp.asarray(b) for b in batch)


def _t(batch):
    return tuple(torch.from_numpy(b) for b in batch)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# --------------------------------------------------------------------------
# the scheduler, the port's and the JAX package's
# --------------------------------------------------------------------------


class _Producer:
    """A live accumulator: a snapshot copies it, a reduce doubles it."""

    def __init__(self, fail_times=0):
        self.lock = threading.Lock()
        self.total = 0
        self.steps = 0
        self.fail_times = fail_times
        self.errors = []

    def bump(self, v):
        with self.lock:
            self.total += v
            self.steps += 1

    def snapshot(self):
        with self.lock:
            return self.total, self.steps

    def reduce(self, total):
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError("transport down")
        return 2 * total

    def on_error(self, err):
        self.errors.append(err)


@pytest.fixture(params=sorted(SCHEDULERS))
def impl(request):
    return SCHEDULERS[request.param]


def test_update_cadence_every_n(impl):
    prod = _Producer()
    sched = impl.AsyncSyncScheduler(prod.snapshot, prod.reduce, sync_every_n=2, name="t")
    try:
        prod.bump(5)
        sched.notify(steps=prod.steps)
        time.sleep(0.1)
        assert sched.view() is None
        prod.bump(7)
        sched.notify(steps=prod.steps)
        assert _wait(lambda: sched.view() is not None)
        assert sched.view().payload == 24 and sched.view().covered_steps == 2
        assert sched.lag(live_steps=2)["sync_lag_steps"] == 0
    finally:
        sched.stop()


def test_time_cadence_and_idle_scheduler(impl):
    prod = _Producer()
    sched = impl.AsyncSyncScheduler(prod.snapshot, prod.reduce, sync_every_n=1000, sync_every_s=0.05, name="t")
    try:
        prod.bump(3)
        sched.notify(steps=prod.steps)
        assert _wait(lambda: sched.view() is not None) and sched.view().payload == 6
    finally:
        sched.stop()
    calls = []
    sched = impl.AsyncSyncScheduler(prod.snapshot, lambda t: calls.append(t) or t, sync_every_n=None, sync_every_s=0.02, name="t")
    try:
        sched.notify(steps=1)
        assert _wait(lambda: len(calls) == 1)
        time.sleep(0.2)
        assert len(calls) == 1  # an idle cadence derives no second view
    finally:
        sched.stop()


def test_failed_cycle_keeps_old_view_and_retries(impl):
    prod = _Producer()
    sched = impl.AsyncSyncScheduler(prod.snapshot, prod.reduce, sync_every_n=1, sync_every_s=0.02, on_error=prod.on_error, name="t")
    try:
        prod.bump(4)
        sched.notify(steps=prod.steps)
        assert _wait(lambda: sched.view() is not None)
        first = sched.view()
        prod.fail_times = 1
        prod.bump(6)
        sched.notify(steps=prod.steps)
        assert _wait(lambda: len(prod.errors) == 1)
        assert sched.view() is first or sched.view().covered_steps == 1
        assert _wait(lambda: sched.view().covered_steps == 2) and sched.view().payload == 20
    finally:
        sched.stop()


def test_wait_covered_and_stop(impl):
    prod = _Producer()
    sched = impl.AsyncSyncScheduler(prod.snapshot, prod.reduce, sync_every_n=None, name="t")
    try:
        prod.bump(2)
        sched.notify(steps=prod.steps)
        assert sched.wait_covered(sched.seq(), deadline_s=10.0) and sched.covered(sched.seq())
    finally:
        sched.stop()
    stopped = impl.AsyncSyncScheduler(prod.snapshot, prod.reduce, sync_every_n=None, name="t2")
    stopped.stop()
    stopped.notify(steps=1)
    t0 = time.monotonic()
    assert not stopped.wait_covered(stopped.seq(), deadline_s=5.0) and time.monotonic() - t0 < 1.0
    # a waiter blocked when stop(final=False) lands wakes at once
    failing = _Producer(fail_times=1000)
    sched = impl.AsyncSyncScheduler(failing.snapshot, failing.reduce, sync_every_n=1000, name="t3")
    sched.notify(steps=1)
    result = {}

    def waiter():
        t0 = time.monotonic()
        result["covered"] = sched.wait_covered(sched.seq(), deadline_s=30.0)
        result["elapsed"] = time.monotonic() - t0

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.1)
    sched.stop(final=False)
    th.join(timeout=10.0)
    assert result == {"covered": False, "elapsed": result["elapsed"]} and result["elapsed"] < 5.0


def test_final_pass_and_steps_watermark(impl):
    prod = _Producer()
    sched = impl.AsyncSyncScheduler(prod.snapshot, prod.reduce, sync_every_n=1000, name="t")
    prod.bump(9)
    sched.notify(steps=prod.steps)
    sched.stop(final=True)
    assert sched.view().payload == 18
    sched = impl.AsyncSyncScheduler(prod.snapshot, prod.reduce, sync_every_n=1000, name="t")
    sched.notify(steps=1)
    sched.stop(final=False)
    assert sched.view() is None
    sched = impl.AsyncSyncScheduler(lambda: (prod.snapshot()[0], None), prod.reduce, sync_every_n=1, name="t")
    try:
        for v in range(7):
            sched.notify()
        assert _wait(lambda: sched.covered())
        assert sched.lag()["sync_lag_steps"] == 0 and sched.view().covered_steps == 7
    finally:
        sched.stop()


def test_view_is_never_torn(impl):
    prod = _Producer()
    totals = {}

    def snapshot():
        with prod.lock:
            totals[prod.steps] = prod.total
            return (prod.total, prod.steps), prod.steps

    sched = impl.AsyncSyncScheduler(snapshot, lambda p: (2 * p[0], p[1]), sync_every_n=1, name="t")
    stop, torn = threading.Event(), []

    def reader():
        while not stop.is_set():
            v = sched.view()
            if v is not None and (v.payload[0] != 2 * totals[v.payload[1]] or v.covered_steps != v.payload[1]):
                torn.append(v)

    th = threading.Thread(target=reader)
    th.start()
    for i in range(200):
        prod.bump(i)
        sched.notify(steps=prod.steps)
    sched.stop(final=True)
    stop.set()
    th.join()
    assert not torn and sched.view().payload == (2 * prod.total, prod.steps)


def test_cadence_resolution_matches_jax(monkeypatch):
    for args in ((None, None), (4, None), (None, 2.5), (2, 1.0)):
        assert port_async.resolve_sync_cadence(*args) == jax_async.resolve_sync_cadence(*args)
    monkeypatch.setenv("METRICS_TPU_SYNC_EVERY_N", "8")
    monkeypatch.setenv("METRICS_TPU_SYNC_EVERY_S", "0.5")
    port_async.reset_async_sync_state()
    assert port_async.resolve_sync_cadence(None, None) == (8, 0.5)
    with pytest.raises(ValueError, match="sync_every_n"):
        port_async.resolve_sync_cadence(0, None)
    monkeypatch.setenv("METRICS_TPU_SYNC_EVERY_N", "not-a-number")
    monkeypatch.setenv("METRICS_TPU_SYNC_EVERY_S", "-3")
    port_async.reset_async_sync_state()
    with pytest.warns(UserWarning) as rec:
        assert port_async.resolve_sync_cadence(None, None) == (1, None)
    msgs = "\n".join(str(w.message) for w in rec)
    assert "METRICS_TPU_SYNC_EVERY_N" in msgs and "METRICS_TPU_SYNC_EVERY_S" in msgs
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert port_async.resolve_sync_cadence(None, None) == (1, None)


# --------------------------------------------------------------------------
# the overlapped metric, against the JAX package's
# --------------------------------------------------------------------------


def _pair(cls_name, twin=None, **kw):
    """A JAX metric and its port in the simulated world of two ranks."""
    jm = getattr(mt, cls_name)(dist_sync_fn=jax_two_rank_gather, **kw)
    tm = getattr(mtt, cls_name)(dist_sync_fn=twin or TwinWorld(), device="cpu", **kw)
    return jm, tm


def _state_numpy(state):
    out = {}
    for k, v in state.items():
        out[k] = [np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v)
    return out


def test_overlapped_read_equals_blocking_and_jax(two_ranks):
    jm, tm = _pair("Accuracy", num_classes=4, sync_mode="overlapped", sync_every_n=10_000)
    _, tref = _pair("Accuracy", num_classes=4)
    for b in _batches(0, 3, 16):
        jm.update(*_j(b))
        tm.update(*_t(b))
        tref.update(*_t(b))
    assert jm.request_sync(wait=True, deadline_s=30.0) and tm.request_sync(wait=True, deadline_s=30.0)
    twin = tm.dist_sync_fn
    n = len(twin.calls)
    value = float(tm.compute())
    assert len(twin.calls) == n  # the read made no collective
    assert value == float(tref.compute()) == float(jm.compute())
    view_state, _ = tm._sync_scheduler.view().payload
    jax_view = jm._sync_scheduler.view().payload
    for key in ("tp", "fp", "tn", "fn"):
        assert np.array_equal(view_state[key].numpy(), np.asarray(jax_view[key])), key


def test_staleness_bounded_by_one_cycle_and_fresh_escape_hatch(two_ranks):
    batches = _batches(1, 4, 12)
    jm, tm = _pair("Accuracy", num_classes=4, sync_mode="overlapped", sync_every_n=10_000)
    for b in batches[:2]:
        jm.update(*_j(b))
        tm.update(*_t(b))
    assert tm.request_sync(wait=True, deadline_s=30.0) and jm.request_sync(wait=True, deadline_s=30.0)
    for b in batches[2:]:
        jm.update(*_j(b))
        tm.update(*_t(b))
    assert float(tm.compute()) == float(jm.compute())
    lag = tm.sync_lag
    assert lag["sync_lag_steps"] == 2 == jm.sync_lag["sync_lag_steps"]
    assert lag["synced_once"] and lag["sync_lag_s"] is not None
    assert float(tm.compute(fresh=True)) == float(jm.compute(fresh=True))


def test_overlapped_fault_counters_are_global_at_cycle(two_ranks):
    p, t = _batches(2, 1, 10)[0]
    p[0] = np.nan
    jm, tm = _pair("Accuracy", num_classes=4, sync_mode="overlapped", sync_every_n=10_000, on_invalid="drop")
    jm.update(*_j((p, t)))
    tm.update(*_t((p, t)))
    assert tm.request_sync(wait=True, deadline_s=30.0) and jm.request_sync(wait=True, deadline_s=30.0)
    assert float(tm.compute()) == float(jm.compute())
    counts = tm._sync_scheduler.view().payload[0]["_faults"].as_dict()
    assert counts["nonfinite_preds"] == 2 and counts["dropped_rows"] == 2
    want = dict(zip(mt.FAULT_CLASSES, np.asarray(jm._sync_scheduler.view().payload["_faults"].counts).tolist()))
    assert counts == want


def test_single_process_overlapped_is_the_identity():
    b = _batches(3, 1, 8)[0]
    tm = mtt.Accuracy(num_classes=4, sync_mode="overlapped", device="cpu")
    ref = mtt.Accuracy(num_classes=4, device="cpu")
    tm.update(*_t(b))
    ref.update(*_t(b))
    assert tm.request_sync(wait=True, deadline_s=30.0)
    assert float(tm.compute()) == float(ref.compute())


def test_windowed_and_decayed_wrappers_under_overlapped_sync(two_ranks):
    stream = _batches(4, 7, 8)
    kw = dict(sync_mode="overlapped", sync_every_n=10_000)
    jw = mt.WindowedMetric(mt.Accuracy(num_classes=4), window=32, buckets=2, dist_sync_fn=jax_two_rank_gather, **kw)
    tw = mtt.WindowedMetric(mtt.Accuracy(num_classes=4, device="cpu"), window=32, buckets=2, dist_sync_fn=TwinWorld(), **kw)
    tref = mtt.WindowedMetric(mtt.Accuracy(num_classes=4, device="cpu"), window=32, buckets=2, dist_sync_fn=TwinWorld())
    for b in stream:
        jw.update(*_j(b))
        tw.update(*_t(b))
        tref.update(*_t(b))
    assert tw.request_sync(wait=True, deadline_s=30.0) and jw.request_sync(wait=True, deadline_s=30.0)
    assert float(tw.compute()) == float(tref.compute()) == float(jw.compute())
    rng = np.random.default_rng(5)
    jd = mt.DecayedMetric(mt.MeanMetric(), halflife=64.0, dist_sync_fn=jax_two_rank_gather, **kw)
    td = mtt.DecayedMetric(mtt.MeanMetric(device="cpu"), halflife=64.0, dist_sync_fn=TwinWorld(), **kw)
    dref = mtt.DecayedMetric(mtt.MeanMetric(device="cpu"), halflife=64.0, dist_sync_fn=TwinWorld())
    for _ in range(5):
        v = rng.random(16).astype(np.float32)
        jd.update(jnp.asarray(v))
        td.update(torch.from_numpy(v))
        dref.update(torch.from_numpy(v))
    assert td.request_sync(wait=True, deadline_s=30.0) and jd.request_sync(wait=True, deadline_s=30.0)
    assert torch.equal(td.compute(), dref.compute())
    # a float32 mean summed in another order (W4)
    np.testing.assert_allclose(float(td.compute()), float(jd.compute()), rtol=1e-6, atol=2e-5)


class _FlakyTwin(TwinWorld):
    def __init__(self):
        super().__init__()
        self.ok = True

    def all_reduce(self, tensor, op=None, group=None):
        if not self.ok:
            raise RuntimeError("world unreachable")
        return super().all_reduce(tensor) if op is None else super().all_reduce(tensor, op)


def test_failed_cycle_degrades_loudly_to_the_previous_view(two_ranks):
    b1, b2 = _batches(6, 2, 8)
    flaky = _FlakyTwin()
    tm = mtt.Accuracy(num_classes=4, sync_mode="overlapped", sync_every_n=10_000, dist_sync_fn=flaky, device="cpu")
    at_cycle = mtt.Accuracy(num_classes=4, dist_sync_fn=TwinWorld(), device="cpu")
    tm.update(*_t(b1))
    at_cycle.update(*_t(b1))
    assert tm.request_sync(wait=True, deadline_s=30.0)
    flaky.ok = False
    tm.update(*_t(b2))
    assert not tm.request_sync(wait=True, deadline_s=1.0)
    assert registry.counts().get("async_sync_error", 0) >= 1
    t0 = time.monotonic()
    assert float(tm.compute()) == float(at_cycle.compute()) and time.monotonic() - t0 < 5.0
    assert tm.sync_lag["sync_lag_steps"] == 1


def test_health_report_sync_lag_fields(two_ranks):
    b = _batches(7, 1, 8)[0]
    jm, tm = _pair("Accuracy", num_classes=4, sync_mode="overlapped", sync_every_n=10_000)
    tm.update(*_t(b))
    jm.update(*_j(b))
    entry, jentry = health_report(tm)["metrics"]["Accuracy"], mt.health_report(jm)["metrics"]["Accuracy"]
    assert entry["sync_mode"] == "overlapped" == jentry["sync_mode"]
    assert entry["sync_lag_steps"] == 1 == jentry["sync_lag_steps"] and entry["sync_lag_s"] is None
    assert tm.request_sync(wait=True, deadline_s=30.0)
    rep = health_report(tm)
    assert rep["metrics"]["Accuracy"]["sync_lag_steps"] == 0 and rep["metrics"]["Accuracy"]["sync_lag_s"] is not None
    # the backend and runtime keys are JAX's since D16 closed (`runtime`
    # appears once a telemetry counter exists in either package)
    assert rep["degraded"] is False and "backend" in rep
    assert set(rep) - {"runtime"} == set(mt.health_report(jm)) - {"runtime"}
    blocking = mtt.Accuracy(num_classes=4, device="cpu")
    blocking.update(*_t(b))
    assert "sync_lag_steps" not in health_report(blocking)["metrics"]["Accuracy"]


def _collection(pkg, gather, **kw):
    dev = {} if pkg is mt else {"device": "cpu"}
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=4, dist_sync_fn=gather, **dev, **kw),
        "prec": pkg.Precision(num_classes=4, average="macro", dist_sync_fn=gather, **dev, **kw),
        "rec": pkg.Recall(num_classes=4, average="macro", dist_sync_fn=gather, **dev, **kw),
        "f1": pkg.F1Score(num_classes=4, average="macro", dist_sync_fn=gather, **dev, **kw),
    })


@pytest.mark.parametrize("transport", ["exact", "int8"])
def test_collection_shares_one_scheduler(two_ranks, transport):
    pre = {t.ident for t in threading.enumerate() if t.name.startswith("metrics-tpu-async-sync")}
    twin = TwinWorld()
    kw = dict(sync_mode="overlapped", sync_every_n=10_000, sync_transport=transport)
    coll = _collection(mtt, twin, **kw)
    ref = _collection(mtt, TwinWorld())
    batches = _batches(8, 2, 16)
    for b in batches:
        coll.update(*_t(b))
        ref.update(*_t(b))
    members = dict(coll.items(keep_base=True, copy_state=False))
    assert any(len(cg) > 1 for cg in coll.compute_groups.values())
    assert len({id(m.__dict__["_sync_scheduler"]) for m in members.values()}) == 1
    assert all(m.__dict__["_sync_view_key"] == name for name, m in members.items())
    alive = [t for t in threading.enumerate() if t.name.startswith("metrics-tpu-async-sync") and t.ident not in pre]
    assert len(alive) == 1, [t.name for t in alive]
    jcoll = _collection(mt, jax_two_rank_gather, **kw)
    for b in batches:
        jcoll.update(*_j(b))
    assert members["acc"].request_sync(wait=True, deadline_s=30.0)
    assert next(iter(dict(jcoll.items(keep_base=True, copy_state=False)).values())).request_sync(wait=True, deadline_s=30.0)
    n = len(twin.calls)
    vals, jvals, ref_vals = coll.compute(), jcoll.compute(), ref.compute()
    assert len(twin.calls) == n  # every member read its view: no collective
    for key in vals:  # no float leaf of these members reaches 64 lanes: int8 ships them exact
        assert float(vals[key]) == float(ref_vals[key]) == float(jvals[key]), key
    assert all(m.sync_lag["sync_lag_steps"] == 0 for m in members.values())
    fresh = coll.compute(fresh=True)
    assert len(twin.calls) > n
    assert all(float(fresh[k]) == float(ref_vals[k]) for k in fresh)
    coll.reset()
    assert all(m.__dict__["_sync_scheduler"] is None for m in members.values())


def test_clone_pickle_and_reset_drop_the_scheduler(two_ranks):
    b = _batches(9, 1, 8)[0]
    tm = mtt.Accuracy(num_classes=4, sync_mode="overlapped", sync_every_n=10_000, dist_sync_fn=TwinWorld(), device="cpu")
    tm.update(*_t(b))
    assert tm.request_sync(wait=True, deadline_s=30.0)
    for copy in (tm.clone(), pickle.loads(pickle.dumps(tm))):
        assert copy.__dict__["_sync_scheduler"] is None and copy.sync_mode == "overlapped"
        copy.update(*_t(b))
        assert copy.request_sync(wait=True, deadline_s=30.0)
        copy.reset()
    thread = tm._sync_scheduler._thread
    tm.reset()
    assert tm.__dict__["_sync_scheduler"] is None and tm.sync_lag["synced_once"] is False
    assert _wait(lambda: not thread.is_alive())
    tm.update(*_t(b))
    assert tm.request_sync(wait=True, deadline_s=30.0)
    ref = mtt.Accuracy(num_classes=4, dist_sync_fn=TwinWorld(), device="cpu")
    ref.update(*_t(b))
    assert float(tm.compute()) == float(ref.compute())


def test_forward_returns_batch_values_not_the_view(two_ranks):
    jm, tm = _pair("Accuracy", num_classes=4, sync_mode="overlapped", sync_every_n=10_000)
    blocking = mtt.Accuracy(num_classes=4, dist_sync_fn=TwinWorld(), device="cpu")
    for b in _batches(11, 3, 8):
        assert float(tm(*_t(b))) == float(blocking(*_t(b))) == float(jm(*_j(b)))
    assert tm.request_sync(wait=True, deadline_s=30.0)
    assert float(tm.compute()) == float(blocking.compute())


STREAM = [np.random.default_rng(seed).lognormal(0, 2, 2000).astype(np.float32) for seed in range(4)]


def _sketch(pkg, transport, gather, every_n=10_000):
    dev = {} if pkg is mt else {"device": "cpu"}
    return pkg.QuantileSketch(eps=0.05, max_items=1 << 20, quantiles=(0.5, 0.99), sync_mode="overlapped",
                              sync_every_n=every_n, sync_transport=transport, dist_sync_fn=gather, **dev)


@pytest.mark.parametrize("transport", ["exact", "int8", "fp16"])
def test_quantized_cycles_against_jax(two_ranks, transport, monkeypatch):
    """The host wire's rule: a quantile sketch's items ship quantized, its
    counts exact; the views are bit-equal to JAX's, and ``fresh=True`` is
    the exact blocking read. The exact transport scatters each rank's
    payload at its own offset, which a twin world cannot mirror, so the
    port's two ranks are two metrics on one ``ThreadWorld`` (each cycle
    on request only, so the ranks' cycles pair)."""
    monkeypatch.setattr(sync_mod, "gather_sequence_lock", contextlib.nullcontext())
    world = ThreadWorld(2)
    ranks = [_sketch(mtt, transport, world.comm(r)) for r in range(2)]
    jm = _sketch(mt, transport, jax_two_rank_gather)
    for vals in STREAM:
        for m in ranks:
            m.update(torch.from_numpy(vals))
        jm.update(jnp.asarray(vals))
    for m in ranks:
        m.request_sync()
    assert all(m.request_sync(wait=True, deadline_s=30.0) for m in ranks) and jm.request_sync(wait=True, deadline_s=30.0)
    theirs = jm._sync_scheduler.view().payload["sketch"]
    for m in ranks:
        ours = m._sync_scheduler.view().payload[0]["sketch"]
        for field in ("items", "counts", "n_seen"):
            assert np.array_equal(getattr(ours, field).numpy(), np.asarray(getattr(theirs, field))), field
        assert np.array_equal(m.compute().numpy(), np.asarray(jm.compute()))
    fresh = world.run(lambda rank, comm: ranks[rank].compute(fresh=True))
    assert np.array_equal(fresh[0].numpy(), np.asarray(jm.compute(fresh=True))) and torch.equal(fresh[0], fresh[1])
    for m in ranks:
        m.reset()


def test_int8_cycle_of_a_large_float_leaf_against_jax(two_ranks):
    """BinnedAveragePrecision's (C, T) float32 counters (>= 64 lanes) ship on
    the int8 host wire; its view's states are JAX's, bit for bit."""
    kw = dict(num_classes=4, thresholds=20, sync_mode="overlapped", sync_every_n=10_000, sync_transport="int8")
    jm, tm = _pair("BinnedAveragePrecision", **kw)
    for b in _batches(12, 3, 32):
        jm.update(*_j(b))
        tm.update(*_t(b))
    assert tm.request_sync(wait=True, deadline_s=30.0) and jm.request_sync(wait=True, deadline_s=30.0)
    ours, theirs = tm._sync_scheduler.view().payload[0], jm._sync_scheduler.view().payload
    for key in ("TPs", "FPs", "FNs"):
        assert np.array_equal(ours[key].numpy(), np.asarray(theirs[key])), key
    tm.reset()


def test_transport_from_the_environment_reaches_the_cycle(two_ranks, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_TRANSPORT", "int8")
    tq.reset_transport_env_state()
    twin = TwinWorld()
    tm = _sketch(mtt, None, twin, every_n=1)
    tm.update(torch.from_numpy(STREAM[0]))
    assert tm.request_sync(wait=True, deadline_s=30.0)
    assert any(c[0] == "all_gather" and c[1].dtype == torch.uint8 for c in twin.calls)
    tm.reset()


def test_ctor_refusals_match_jax():
    for kw, match in (
        (dict(sync_mode="overlapped", sync_transport="int4"), "sync_transport"),
        (dict(sync_transport="int8"), "overlapped"),
        (dict(sync_mode="weird"), "sync_mode"),
        (dict(sync_every_n=3), "overlapped"),
        (dict(sync_mode="overlapped", sync_every_n=0), "sync_every_n"),
    ):
        with pytest.raises(ValueError, match=match):
            mt.MeanMetric(**kw)
        with pytest.raises(ValueError, match=match):
            mtt.MeanMetric(device="cpu", **kw)
    mtt.MeanMetric(sync_transport="exact", device="cpu")


def test_jax_overlapped_state_carries_over(two_ranks):
    """An overlapped JAX metric's live state loads into the port's; the view
    is not carried, and the port's next cycle builds it."""
    from metrics_tpu_torch.interop import load_jax_state

    jm, tm = _pair("Accuracy", num_classes=4, sync_mode="overlapped", sync_every_n=10_000, on_invalid="drop")
    batches = _batches(13, 3, 16)
    for b in batches[:2]:
        jm.update(*_j(b))
    load_jax_state(tm, {k: np.asarray(getattr(v, "counts", v)) for k, v in jm.metric_state.items()})
    assert tm.__dict__["_sync_scheduler"] is None
    jm.update(*_j(batches[2]))
    tm.update(*_t(batches[2]))
    assert tm.request_sync(wait=True, deadline_s=30.0) and jm.request_sync(wait=True, deadline_s=30.0)
    assert float(tm.compute()) == float(jm.compute())
    for key in ("tp", "fp", "tn", "fn"):
        assert np.array_equal(tm._sync_scheduler.view().payload[0][key].numpy(), np.asarray(jm._sync_scheduler.view().payload[key]))
    tm.reset()


def test_int8_cycle_of_list_states_against_jax(two_ranks):
    """AUROC's list states on the int8 host wire: each rank's float scores
    (>= 64 lanes) ship quantized, its labels exact, and the ragged rows
    decode to their own lengths; the view's AUROC is JAX's."""
    rng = np.random.default_rng(14)
    kw = dict(sync_mode="overlapped", sync_every_n=10_000, sync_transport="int8")
    jm, tm = _pair("AUROC", **kw)
    for rows in (70, 45):
        scores, labels = rng.random(rows).astype(np.float32), (rng.random(rows) < 0.4).astype(np.int32)
        jm.update(jnp.asarray(scores), jnp.asarray(labels))
        tm.update(torch.from_numpy(scores), torch.from_numpy(labels))
    assert tm.request_sync(wait=True, deadline_s=30.0) and jm.request_sync(wait=True, deadline_s=30.0)
    assert any(c[0] == "all_gather" and c[1].dtype == torch.uint8 for c in tm.dist_sync_fn.calls)
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=0, atol=1e-6)
    tm.reset()
