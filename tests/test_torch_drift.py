"""The port's ``DriftMonitor`` and ``ReferenceWindow`` (``obs/drift.py``)
against the JAX package's, on the same seeded streams.

After every check the three live sketches are bit-equal to JAX's (the
CountMin counters as int64 here, uint32 there); the scores agree within
``SCORE_ATOL`` (the HLL estimate sums its float32 terms in another order:
D57), and the breaches, episodes and health events are the same. A
reference's primitives load across the packages both ways. The port's
``observe`` reads nothing back and returns a device count (D54).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import metrics_tpu as mt  # noqa: E402
from metrics_tpu.obs import drift as jdrift  # noqa: E402
from metrics_tpu_torch.obs import drift as tdrift  # noqa: E402
from metrics_tpu_torch.resilience import health as thealth  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402

SCORE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _clean():
    thealth.registry.clear()
    mt.resilience.health.registry.clear()
    tdrift.reset_drift_env_state()
    jdrift.reset_drift_env_state()
    yield
    thealth.registry.clear()
    mt.resilience.health.registry.clear()
    tdrift.reset_drift_env_state()
    jdrift.reset_drift_env_state()


def _pair(name="m", **kw):
    return jdrift.DriftMonitor(name, **kw), tdrift.DriftMonitor(name, device="cpu", **kw)


def _states_equal(jm, tm):
    if jm._q is None:
        assert tm._q is None
        return
    for j, t in ((jm._q, tm._q), (jm._cm, tm._cm), (jm._hll, tm._hll)):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a).astype(np.float64), b.numpy().astype(np.float64))


def _scores_close(js, ts):
    for k in tdrift.DRIFT_SCORES:
        a, b = js["scores"][k], ts["scores"][k]
        assert (a is None) == (b is None), k
        if a is not None:
            assert abs(a - b) <= SCORE_ATOL, (k, a, b)
    for key in ("active", "breaching", "windows", "checks", "breaches", "dropped_rows", "detected_events",
                "recovered_events", "window_rows", "thresholds"):
        assert js[key] == ts[key], key


def _events(registry):
    return [(e["kind"], e.get("details", {}).get("monitor"), tuple(e.get("details", {}).get("breaching", ())))
            for e in registry.events() if e["kind"].startswith("drift_")]


def _lognormal(rng, n, shift):
    x = rng.lognormal(size=n).astype(np.float32) * np.float32(math.exp(shift))
    x[rng.random(n) < 0.01] = np.nan
    x[rng.random(n) < 0.002] = np.inf
    return x


def _zipf_ids(rng, n, permuted):
    ranks = np.minimum(rng.zipf(1.3, n), 5000) - 1
    ids = np.arange(5000) * 7 + 11
    if permuted:
        ids = np.concatenate([ids[20:40], ids[:20], ids[40:]])  # the hot set moves
    return ids[ranks]


STREAMS = {
    # (rows per batch, batches, the batch the shift starts at, observes per check)
    "score_shift": (lambda rng, n, shifted: _lognormal(rng, n, 0.5 if shifted else 0.0), (400, 9000), 16, 8, 1),
    "hot_set_churn": (lambda rng, n, shifted: _zipf_ids(rng, n, shifted), (3000, 26000), 12, 7, 2),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_same_stream_same_states_scores_and_events(stream):
    make, (lo, hi), batches, shift_at, per_check = STREAMS[stream]
    rng = np.random.default_rng(7)
    jm, tm = _pair(window=20_000 if stream == "score_shift" else 60_000, eps=0.05)
    for b in range(batches):
        x = make(rng, int(rng.integers(lo, hi)), b >= shift_at)
        jm.observe(x)
        got = tm.observe(x)
        assert isinstance(got, torch.Tensor) and int(got) == int(np.isfinite(x.astype(np.float64)).sum())
        if b % per_check != per_check - 1:
            continue  # several observes before a check: JAX's inline folds
        if b == 3:
            jref, tref = jm.freeze_reference(), tm.freeze_reference()
            assert jref.hh_keys == tref.hh_keys and jref.rows == tref.rows
            jm.set_reference(jref)
            tm.set_reference(tref)
            jm.rotate()
            tm.rotate()
        js, ts = jm.check(), tm.check()
        _states_equal(jm, tm)
        _scores_close(js, ts)
        # the qualifying heavy hitters (the table below the bar may differ on ties: D57)
        assert jm._top_keys_locked() == tm._top_keys_locked()
    assert ts["detected_events"] == 1
    assert _events(thealth.registry) == _events(mt.resilience.health.registry)
    assert tm.fleet_scores().keys() == jm.fleet_scores().keys()


def test_reference_primitives_cross_packages_both_ways():
    rng = np.random.default_rng(3)
    jm, tm = _pair(window=8192, eps=0.05)
    x = _lognormal(rng, 6000, 0.0)
    jm.observe(x)
    tm.observe(x)
    jprim, tprim = jm.freeze_reference().to_primitives(), tm.freeze_reference().to_primitives()
    # the JAX reference into a port monitor, the port's into a JAX monitor
    jm2, tm2 = _pair(window=8192, eps=0.05)
    tm2.load_reference(jprim)
    jm2.load_reference(tprim)
    y = _lognormal(rng, 5000, 0.3)
    jm2.observe(y)
    tm2.observe(y)
    _scores_close(jm2.check(), tm2.check())
    assert thealth.registry.counts()["drift_baseline_loaded"] == 1
    assert not mtt_health()["degraded"]
    with pytest.raises(MetricsTPUUserError, match="schema"):
        tdrift.ReferenceWindow.from_primitives({"schema": "other"}, device="cpu")
    bad = dict(tprim, quantile=dict(tprim["quantile"], counts=np.zeros(2, np.int32)))
    with pytest.raises(MetricsTPUUserError, match="quantile.counts"):
        tdrift.ReferenceWindow.from_primitives(bad, device="cpu")
    other = tdrift.DriftMonitor("o", device="cpu", window=8192, eps=0.05, cm_width=1024)
    with pytest.raises(MetricsTPUUserError, match="CountMin geometry"):
        other.load_reference(tprim)


def mtt_health():
    import metrics_tpu_torch as mtt

    return mtt.health_report()


def test_env_thresholds(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_DRIFT_KS", "banana")
    with pytest.warns(UserWarning, match="METRICS_TPU_DRIFT_KS"):
        assert tdrift.DriftMonitor("a", device="cpu").thresholds["ks"] == 0.15
    monkeypatch.setenv("METRICS_TPU_DRIFT_KS", "0.3")
    monkeypatch.setenv("METRICS_TPU_DRIFT_CARDINALITY_RATIO", "0.5")  # <= 1 breaches always: refused
    with pytest.warns(UserWarning, match="METRICS_TPU_DRIFT_CARDINALITY_RATIO"):
        mon = tdrift.DriftMonitor("b", device="cpu")
    assert mon.thresholds == jdrift.DriftMonitor("b").thresholds
    assert mon.thresholds["ks"] == 0.3 and mon.thresholds["cardinality_ratio"] == 2.0
    assert tdrift.DriftMonitor("c", device="cpu", ks_threshold=0.4).thresholds["ks"] == 0.4
    with pytest.raises(MetricsTPUUserError):
        tdrift.DriftMonitor("d", device="cpu", cardinality_ratio_threshold=1.0)


def test_slice_id_filters_host_and_device_requests_alike():
    rng = np.random.default_rng(5)
    jm, tm = _pair(slice_id=2, window=4096, eps=0.05)
    dev = tdrift.DriftMonitor("m", device="cpu", slice_id=2, window=4096, eps=0.05)
    for _ in range(6):
        x = _lognormal(rng, 700, 0.0)
        ids = rng.integers(0, 4, 700)
        valid = rng.random(700) < 0.9
        kwargs = {"slice_ids": ids, "valid": valid}
        jv, tv = jm.extract_from((x,), kwargs), tm.extract_from((x,), kwargs)
        np.testing.assert_array_equal(jv, tv)  # host arrays: JAX's filter
        jm.observe(jv)
        tm.observe(tv)
        masked = dev.extract_from((torch.from_numpy(x),), {"slice_ids": torch.from_numpy(ids), "valid": torch.from_numpy(valid)})
        assert isinstance(masked, tdrift._CohortRows)
        dev.observe(masked)
    js, ts, ds = jm.check(), tm.check(), dev.check()
    _states_equal(jm, tm)
    _states_equal(jm, dev)
    assert js["dropped_rows"] == ts["dropped_rows"] == ds["dropped_rows"]
    assert tm.extract_from((np.ones(3),), {}) is None  # no slice ids: nothing
    assert tm.extract_from((np.ones(3),), {"slice_ids": np.ones(2)}) is None  # misaligned
    assert tm.extract_from((np.ones(3),), {"slice_ids": np.zeros(3)}) is None  # no row of the cohort


def test_poison_input_counts_as_dropped_and_observe_reads_nothing(monkeypatch):
    jm, tm = _pair(window=4096)
    for poison in ("abc", np.array(["x", "y"]), object()):
        assert jm.observe(poison) == 0
        assert int(tm.observe(poison)) == 0
    x = np.array([1.0, np.nan, np.inf, -np.inf, 2.0, 3.0], np.float32)

    def boom(*args, **kwargs):
        raise AssertionError("observe read a tensor back")

    with monkeypatch.context() as m:
        for name in ("tolist", "item", "numpy", "cpu", "__bool__", "__int__", "__index__"):
            m.setattr(torch.Tensor, name, boom)
        got = tm.observe(torch.from_numpy(x))
    assert int(got) == jm.observe(x) == 3
    assert tm.window_rows == 6 and tm.dropped_rows == 3  # pending rows count until they fold
    js, ts = jm.check(), tm.check()
    assert js["dropped_rows"] == ts["dropped_rows"] == 6
    assert js["window_rows"] == ts["window_rows"] == 3


def _hot_zero_stream(rng, n, canonical):
    """A stream whose hot key is zero: as ``-0.0``, ``+0.0``, denormals and
    NaN rows mixed in, or (``canonical``) all ``+0.0`` with the NaNs gone."""
    x = rng.lognormal(size=n).astype(np.float32)
    hot = rng.random(n) < 0.3
    forms = np.array([0.0, -0.0, 1e-40, -3e-41], np.float32)
    x[hot] = forms[rng.integers(0, 4, n)][hot]
    nan = rng.random(n) < 0.01
    x[nan] = np.nan
    if canonical:
        x = x[~nan]
        x[np.abs(x) < np.finfo(np.float32).tiny] = 0.0
    return x


def test_hh_churn_over_signed_zeros_denormals_and_nan():
    """W1: the port's candidates take ``-0.0``, ``+0.0`` and denormals as one
    key (``flush_denormals`` and the orderable key), as its CountMin hashes
    them; NaN rows drop. Its scores on the mixed stream equal its own and
    JAX's on the canonical stream (JAX's jitted hash sees ``-0.0`` and
    denormals by their bits, D3, so JAX is held on the canonical one)."""
    runs = {}
    for canonical in (False, True):
        rng = np.random.default_rng(11)
        mon = tdrift.DriftMonitor("z", device="cpu", window=15_000, eps=0.05)
        ref = jdrift.DriftMonitor("z", window=15_000, eps=0.05) if canonical else None
        statuses = []
        for b in range(9):
            x = _hot_zero_stream(rng, 5000, canonical)
            if b >= 5:
                x = x[np.isnan(x) | (np.abs(x) >= np.finfo(np.float32).tiny)]  # the hot key goes cold
            mon.observe(x)
            if ref is not None:
                ref.observe(x)
            if b == 2:
                for m in (mon, ref) if ref is not None else (mon,):
                    m.set_reference(m.freeze_reference())
                    m.rotate()
            statuses.append((mon.check()["scores"], ref.check()["scores"] if ref is not None else None))
        runs[canonical] = (statuses, mon)
    assert runs[False][1]._reference.hh_keys == runs[True][1]._reference.hh_keys == (0.0,)
    for (mixed, _), (canon, jax_scores) in zip(runs[False][0], runs[True][0]):
        assert mixed["hh_churn"] == canon["hh_churn"] == jax_scores["hh_churn"]
    assert runs[False][0][-1][0]["hh_churn"] == 1.0


def test_fold_chunks_count_the_k3_launches():
    tm = tdrift.DriftMonitor("k", device="cpu", window=1 << 20)
    rng = np.random.default_rng(2)
    sizes = [5000, 40_000, 100, 9000]
    for n in sizes:
        tm.observe(rng.lognormal(size=n).astype(np.float32))
    tm.check()
    # fold groups as JAX's inline folds make them: [5000, 40000] then [100, 9000]
    assert tm.fold_chunks == math.ceil(45_000 / 4096) + math.ceil(9100 / 4096)
    assert tdrift.DriftMonitor("d", device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(MetricsTPUUserError, match="CUDA"):
            tdrift.DriftMonitor("d")
