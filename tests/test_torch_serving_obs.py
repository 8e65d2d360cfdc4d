"""``ServeLoop`` with snapshots, drift monitors, scrapes, tracing and the
flight recorder (``metrics_tpu_torch/serving/loop.py``), against the JAX
package's ``ServeLoop`` on the same requests.

A loop restored from ``save_snapshot()`` reports values bit-equal to the
served loop's, and equal to JAX's loop over the same requests (and to JAX's
restore of the port's files); a drifting stream trips one
``drift_detected`` within a window rotation in both; ``scrape()`` carries
JAX's health-derived metric names and ``health()`` JAX's keys.
"""
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.ops import padding as jpadding  # noqa: E402
from metrics_tpu_torch.obs import flightrec as tflight  # noqa: E402
from metrics_tpu_torch.obs import runtime_metrics as trm  # noqa: E402
from metrics_tpu_torch.obs import trace as ttrace  # noqa: E402
from metrics_tpu_torch.ops import padding  # noqa: E402
from metrics_tpu_torch.resilience.health import registry  # noqa: E402

C = 4


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_PAD_LADDER", "16")
    padding.reset_padding_state()
    jpadding.reset_padding_state()
    registry.clear()
    mt.resilience.health.registry.clear()
    ttrace.reset_trace_state()
    trm.registry.reset()
    trm.registry.fold_device = "cpu"
    yield
    registry.clear()
    mt.resilience.health.registry.clear()
    ttrace.reset_trace_state()
    trm.registry.reset()
    trm.registry.fold_device = None
    tflight.reset_flightrec_state()
    padding.reset_padding_state()
    jpadding.reset_padding_state()


def _requests(seed, n_req=10, shift=0.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_req):
        n = int(rng.integers(1, 17))
        p = rng.random((n, C)).astype(np.float32) + np.float32(shift)
        p[0, 0] = np.nan
        out.append((p, rng.integers(0, C, n).astype(np.int32)))
    return out


def _proto(pkg, **dev):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=C, on_invalid="drop", pad_batches=True, **dev),
        "macro": pkg.Accuracy(num_classes=C, average="macro", on_invalid="drop", pad_batches=True, **dev),
    })


def _serve(loop, requests, conv):
    for p, t in requests:
        assert loop.offer(conv(p), conv(t))
    assert loop.drain(120)
    return loop.report(fresh=True, deadline_s=120)


def _same_view(a, b, exact=True):
    assert a["updates"] == b["updates"]
    assert a["faults"] == {k: dict(v) for k, v in b["faults"].items()}
    for name in ("acc", "macro"):
        x, y = float(a["value"][name]), float(b["value"][name])
        assert x == y if exact else abs(x - y) <= 1e-6, (name, x, y)


def test_restore_reports_bit_equal_values_and_matches_jax(tmp_path):
    requests = _requests(3)
    mgr = mtt.SnapshotManager(str(tmp_path / "port"))
    with mtt.ServeLoop(_proto(mtt, device="cpu"), workers=2, snapshot_manager=mgr, snapshot_every_s=0.05) as loop:
        served = _serve(loop, requests, torch.from_numpy)
        deadline = time.monotonic() + 30
        while not mgr.steps() and time.monotonic() < deadline:
            time.sleep(0.02)  # the periodic snapshot rides the reducer's tick
        assert mgr.steps()
        step = loop.save_snapshot()
        assert step in mgr.steps()
    # a fresh loop of another worker count restores the group elastically
    with mtt.ServeLoop(_proto(mtt, device="cpu"), workers=3, snapshot_manager=mgr) as fresh:
        info = fresh.restore_snapshot()
        assert (info["step"], info["old_world"]) == (step, 2)
        restored = fresh.report(fresh=True, deadline_s=120)
    _same_view(restored, served)
    # JAX's loop over the same requests, and JAX restoring the port's files
    with mt.ServeLoop(_proto(mt), workers=2) as jloop:
        jserved = _serve(jloop, requests, jnp.asarray)
    _same_view(served, jserved, exact=False)
    with mt.ServeLoop(_proto(mt), workers=1, snapshot_manager=mt.SnapshotManager(mgr.directory)) as jfresh:
        jfresh.restore_snapshot()
        jrestored = jfresh.report(fresh=True, deadline_s=120)
    _same_view(restored, jrestored, exact=False)
    # a loop that served refuses to restore (its base would count twice)
    with mtt.ServeLoop(_proto(mtt, device="cpu"), workers=1, snapshot_manager=mgr) as busy:
        _serve(busy, requests[:1], torch.from_numpy)
        with pytest.raises(mtt.utilities.exceptions.MetricsTPUUserError, match="already served"):
            busy.restore_snapshot()


def test_saves_after_a_restore_outlive_pruning_and_restore_again(tmp_path):
    """ROADMAP F11, repaired in the port (D59): a restored loop's saves go
    on after the restored step, so a second restore holds the traffic
    served since the first."""
    requests = _requests(5, n_req=8)
    mgr = mtt.SnapshotManager(str(tmp_path), keep=2)
    with mtt.ServeLoop(_proto(mtt, device="cpu"), workers=2, snapshot_manager=mgr) as first:
        _serve(first, requests[:4], torch.from_numpy)
        for step in (100_000, 200_000, 300_000):  # a job's own step numbers
            first.save_snapshot(step)
    with mtt.ServeLoop(_proto(mtt, device="cpu"), workers=2, snapshot_manager=mgr, snapshot_every_s=0.05) as second:
        assert second.restore_snapshot()["step"] == 300_000
        _serve(second, requests[4:], torch.from_numpy)
        deadline = time.monotonic() + 30
        while max(mgr.steps()) <= 300_000 and time.monotonic() < deadline:
            time.sleep(0.02)  # the periodic save rides the reducer's tick
        assert max(mgr.steps()) > 300_000
        assert second.save_snapshot() > 300_001
    # the restored steps are pruned, the newest saves kept (a periodic save
    # may follow the explicit one)
    steps = mgr.steps()
    assert len(steps) == 2 and steps[0] > 300_000
    with mtt.ServeLoop(_proto(mtt, device="cpu"), workers=1, snapshot_manager=mgr) as third:
        assert third.restore_snapshot()["step"] == steps[-1]
        restored = third.report(fresh=True, deadline_s=120)
    with mtt.ServeLoop(_proto(mtt, device="cpu"), workers=2) as whole:
        served = _serve(whole, requests, torch.from_numpy)
    _same_view(restored, served)


@pytest.mark.reference_fault
def test_jax_loop_saves_after_a_restore_are_pruned_at_once(tmp_path):
    """ROADMAP F11 (reference-side): JAX's loop numbers its saves from 1
    after a restore, so each falls below the restored steps and is pruned
    as soon as it is written."""
    mgr = mt.SnapshotManager(str(tmp_path), keep=2)
    with mt.ServeLoop(_proto(mt), workers=1, snapshot_manager=mgr) as first:
        _serve(first, _requests(5, n_req=2), jnp.asarray)
        for _ in range(3):
            first.save_snapshot()
    with mt.ServeLoop(_proto(mt), workers=1, snapshot_manager=mgr) as second:
        assert second.restore_snapshot()["step"] == 3
        assert second.save_snapshot() == 1
    assert mgr.steps() == [2, 3]


def _confidence(args, kwargs):
    p = args[0]
    return p.max(dim=1).values if isinstance(p, torch.Tensor) else np.asarray(p).max(axis=1)


def _drift_run(pkg, conv, monitor):
    blessed = _requests(5, n_req=40)
    with pkg.ServeLoop(pkg.Accuracy(num_classes=C, pad_batches=True, **({"device": "cpu"} if pkg is mtt else {})),
                       workers=2, reduce_every_s=0.02, drift_monitors=[monitor]) as loop:
        for p, t in blessed:
            assert loop.offer(conv(np.nan_to_num(p)), conv(t))
        assert loop.drain(60)
        monitor.set_reference(monitor.freeze_reference())
        monitor.rotate()
        detected_at = None
        shifted = _requests(6, n_req=120, shift=0.5)
        for i, (p, t) in enumerate(shifted):
            loop.offer(conv(np.nan_to_num(p)), conv(t))
            if i % 10 == 9:
                assert loop.drain(60)
                time.sleep(0.1)  # a few of the reducer's 0.02 s ticks check what was offered
                if monitor.status()["active"] and detected_at is None:
                    detected_at = (i + 1) * 8.5  # about the rows offered since the shift
        text = loop.scrape()
        health = loop.health()
    return detected_at, text, health


def test_drift_detected_within_a_window_rotation_in_both_packages():
    window = 512  # the blessed requests (about 340 rows) fill less than one window
    tmon = mtt.DriftMonitor("conf", device="cpu", window=window, eps=0.05, extract=_confidence)
    jmon = mt.DriftMonitor("conf", window=window, eps=0.05, extract=_confidence)
    t_at, t_text, t_health = _drift_run(mtt, torch.from_numpy, tmon)
    j_at, j_text, j_health = _drift_run(mt, jnp.asarray, jmon)
    for at, reg in ((t_at, registry), (j_at, mt.resilience.health.registry)):
        assert at is not None and at <= 2 * window  # within a rotation of the shift
        assert reg.counts().get("drift_detected") == 1
        assert reg.counts().get("drift_baseline_loaded") == 1
    assert 'metrics_tpu_drift_active{monitor="conf"} 1' in t_text
    assert 'metrics_tpu_health_events_total{kind="drift_detected"} 1' in t_text
    # `runtime` appears once a counter exists: JAX counts its jit traces, the
    # port captures nothing on the CPU
    assert set(t_health) - {"runtime"} == set(j_health) - {"runtime"}
    assert set(t_health["drift"]["conf"]) == set(j_health["drift"]["conf"])


def _names(text):
    return {re.split(r"[{ ]", line, 1)[0] for line in text.splitlines() if line and not line.startswith("#")}


def test_scrape_names_health_keys_and_the_flight_recorder_source(tmp_path):
    requests = _requests(9)
    rec = tflight.FlightRecorder(str(tmp_path), min_interval_s=0.0)
    tflight.install_flight_recorder(rec)
    views = {}
    for pkg, conv, dev in ((mtt, torch.from_numpy, {"device": "cpu"}), (mt, jnp.asarray, {})):
        mon = pkg.DriftMonitor("conf", window=64, eps=0.05, extract=_confidence, **dev)
        with pkg.ServeLoop(_proto(pkg, **dev), workers=2, drift_monitors={"conf": mon}) as loop:
            _serve(loop, requests, conv)
            views[pkg] = (loop.scrape(), loop.health(), loop.scrape("json"))
            if pkg is mtt:
                path = rec.dump("manual", "a served loop")
                source = tflight.load_flight_record(path)["sources"]["serve:MetricCollection"]
                assert source["serving"]["processed"] == len(requests)
                assert source["serving"]["faults"] == {k: dict(v) for k, v in loop.report()["faults"].items()}
    (t_text, t_health, t_json), (j_text, j_health, _) = views[mtt], views[mt]
    health_line = re.compile(
        r"metrics_tpu_(health|drift|metric_faults|metric_sync|metric_staleness"
        r"|serve_(offered|accepted|shed|processed|failed|queue|workers|dead|report|sync))"
    )
    assert {n for n in _names(t_text) if health_line.match(n)} == {n for n in _names(j_text) if health_line.match(n)}
    assert set(t_health) - {"runtime"} == set(j_health) - {"runtime"} and set(t_health["serving"]) == set(j_health["serving"])
    assert '"serving"' in t_json


def test_traced_serving_spans_one_update_per_request():
    requests = _requests(4, n_req=12)
    with ttrace.force_tracing(True):
        with mtt.ServeLoop(_acc_proto(), workers=2) as loop:
            _serve_pairs(loop, requests)
    records = ttrace.trace_records()
    offers = {r.span_id: r for r in records if r.name == "serve.offer"}
    updates = [r for r in records if r.name == "serve.update"]
    assert len(offers) == len(updates) == len(requests)
    assert all(u.parent_id in offers for u in updates)
    assert trm.registry.histograms()["serve_update_ms"].count == len(requests)
    assert {"serve.reduce", "async_sync.cycle", "metric.update", "metric.compute"} <= {r.name for r in records}


def _acc_proto():
    return mtt.Accuracy(num_classes=C, pad_batches=True, on_invalid="drop", device="cpu")


def _serve_pairs(loop, requests):
    for p, t in requests:
        assert loop.offer(torch.from_numpy(p), torch.from_numpy(t))
    assert loop.drain(60)
    loop.report(fresh=True, deadline_s=60)
