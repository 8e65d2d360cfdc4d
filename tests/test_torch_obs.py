"""The port's observability (``obs/trace.py``, ``obs/runtime_metrics.py``,
``obs/export.py``, ``obs/flightrec.py``) against the JAX package.

The same calls under ``force_tracing(True)`` give the same span names,
parents and attribute keys in both packages (JAX's ``metric.jit_retrace``
instants are its jit traces; the port counts a CUDA-graph capture there,
and captures nothing on the CPU: D56); the Chrome events carry JAX's keys;
a ``LatencyHistogram`` folds into a sketch bit-equal to JAX's, so their
quantiles are equal and within the sketch's ``eps`` rank of the exact
ones; ``merged()``, ``prometheus_text`` and ``json_text`` render the same
names, labels and values over the same contents. The telemetry registry
folds on the CPU here (``fold_device``, D55).
"""
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.obs import flightrec as jflight  # noqa: E402
from metrics_tpu.obs import runtime_metrics as jrm  # noqa: E402
from metrics_tpu.obs import trace as jtrace  # noqa: E402
from metrics_tpu_torch.obs import flightrec as tflight  # noqa: E402
from metrics_tpu_torch.obs import runtime_metrics as trm  # noqa: E402
from metrics_tpu_torch.obs import trace as ttrace  # noqa: E402
from metrics_tpu_torch.resilience import health as thealth  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _obs_on_cpu():
    """Fresh tracers and registries in both packages; the port's telemetry
    folds on the CPU."""
    for mod in (jtrace, ttrace):
        mod.reset_trace_state()
    jrm.registry.reset()
    trm.registry.reset()
    trm.registry.fold_device = "cpu"
    thealth.registry.clear()
    mt.resilience.health.registry.clear()
    yield
    for mod in (jtrace, ttrace):
        mod.reset_trace_state()
    jrm.registry.reset()
    trm.registry.reset()
    trm.registry.fold_device = None
    tflight.reset_flightrec_state()
    jflight.reset_flightrec_state()
    thealth.registry.clear()
    mt.resilience.health.registry.clear()


def _drive(pkg, tmp_path):
    """One user-style pass: two updates, a compute, a snapshot save and a
    restore, under a user span."""
    rng = np.random.default_rng(0)
    conv = torch.from_numpy if pkg is mtt else jnp.asarray
    dev = {"device": "cpu"} if pkg is mtt else {}
    m = pkg.Accuracy(num_classes=4, **dev)
    with pkg.obs.span("user.epoch", epoch=1):
        for _ in range(2):
            m.update(conv(rng.integers(0, 4, 16)), conv(rng.integers(0, 4, 16)))
        m.compute()
    mgr = pkg.SnapshotManager(str(tmp_path / pkg.__name__))
    mgr.save(m, step=1)
    mgr.restore(pkg.Accuracy(num_classes=4, **dev))


def _tree(records):
    """``(name, parent name, attribute keys)`` of every span (not the
    instants), in ring order."""
    by_id = {r.span_id: r for r in records}
    out = []
    for r in records:
        if not r.dur_ns:
            continue
        parent = by_id.get(r.parent_id)
        out.append((r.name, parent.name if parent is not None else None, tuple(sorted(r.attrs or {}))))
    return out


def test_same_spans_parents_and_attribute_keys(tmp_path):
    with jtrace.force_tracing(True):
        _drive(mt, tmp_path)
    with ttrace.force_tracing(True):
        _drive(mtt, tmp_path)
    ours, ref = _tree(ttrace.trace_records()), _tree(jtrace.trace_records())
    assert ours == ref and len(ours) == 6
    # the occurrence counters of those spans, from the sink
    names = {f"{n.replace('.', '_')}_total" for n, _, _ in ours}
    tc, jc = trm.registry.counters(), jrm.registry.counters()
    assert {k: tc[k] for k in names} == {k: jc[k] for k in names}
    # nested spans share the trace id, a span parents under the open one
    recs = {r.name: r for r in ttrace.trace_records()}
    assert recs["metric.update"].trace_id == recs["user.epoch"].trace_id
    assert recs["metric.update"].parent_id == recs["user.epoch"].span_id


def test_chrome_events_have_jax_keys(tmp_path):
    with jtrace.force_tracing(True):
        _drive(mt, tmp_path)
    with ttrace.force_tracing(True):
        _drive(mtt, tmp_path)

    def keys(events):
        out = {}
        for e in events:
            out.setdefault((e["ph"], e["name"] if e["ph"] in ("M", "s", "f") else "span"), set()).update(e)
            if "args" in e and e["ph"] == "X":
                out.setdefault(("args", e["name"]), set()).update(e["args"])
        return out

    ours = keys(ttrace.chrome_trace_events(host_id="h"))
    ref = keys([e for e in jtrace.chrome_trace_events(host_id="h") if e.get("name") != "metric.jit_retrace"])
    assert ours == ref
    path = tmp_path / "trace.json"
    doc = json.loads(ttrace.export_chrome_trace(str(path), host_id="h"))
    assert json.loads(path.read_text()) == doc and doc["displayTimeUnit"] == "ms"
    merged = ttrace.merge_chrome_sections([{"host_id": "a", "clock": ttrace.clock_sync(), "events": doc["traceEvents"]}])
    assert merged["traceEvents"][0]["args"]["name"] == "a"


def test_disabled_span_is_the_shared_noop_and_context_hands_off():
    assert ttrace.span("x") is ttrace.span("y") is ttrace._NOOP_SPAN
    seen = {}
    with ttrace.force_tracing(True):
        with ttrace.span("producer"):
            ctx = ttrace.current_context()

        def consumer():
            seen["before"] = ttrace.current_context()
            with ttrace.trace_context(ctx):
                with ttrace.span("consumer"):
                    pass

        t = threading.Thread(target=consumer)
        t.start()
        t.join()
    recs = {r.name: r for r in ttrace.trace_records()}
    assert seen["before"] is None
    assert recs["consumer"].parent_id == recs["producer"].span_id
    assert ttrace.records_since(recs["producer"].seq) == [recs["consumer"]]


def test_histogram_folds_bit_equal_to_jax_and_within_eps():
    values = np.random.default_rng(1).lognormal(size=20_000).astype(np.float32)
    ours, ref = trm.LatencyHistogram("h", device="cpu"), jrm.LatencyHistogram("h")
    for v in values.tolist():
        ours.observe(v)
        ref.observe(v)
    assert ours._sketch is not None and ref._sketch is not None  # two folds of 8192 ran
    np.testing.assert_array_equal(ours._sketch.items.numpy(), np.asarray(ref._sketch.items))
    np.testing.assert_array_equal(ours._sketch.counts.numpy(), np.asarray(ref._sketch.counts))
    qs = (0.5, 0.9, 0.99, 0.999)
    got, want = ours.quantiles(qs), ref.quantiles(qs)
    assert got == want
    exact = np.sort(values.astype(np.float64))
    for q in qs:
        rank = np.searchsorted(exact, got[q], side="right")
        assert abs(rank - q * values.size) <= ours.eps * values.size
    assert ours.count == ref.count and ours.sum_ms == pytest.approx(ref.sum_ms, rel=1e-12)


def _fill(pkg_rm, seed):
    reg = pkg_rm.RuntimeMetrics(**({"fold_device": "cpu"} if pkg_rm is trm else {}))
    rng = np.random.default_rng(seed)
    reg.counter("serve_offer_total").inc(3 + seed)
    reg.counter("sync_payload_bytes").inc(4096 * (seed + 1))
    reg.gauge("serve_warmup_seconds").set(1.5 + seed)
    for v in rng.lognormal(size=3000).tolist():
        reg.histogram("serve_update_ms").observe(v)
    for v in rng.lognormal(size=100).tolist():
        reg.histogram("snapshot_save_ms").observe(v)
    return reg


HEALTH = {
    "degraded": True,
    "event_counts": {"overload_shed": 2, "drift_detected": 1},
    "serving": {"offered": 10, "accepted": 9, "shed": 1, "processed": 9, "failed": 0, "queue_depth": 0,
                "queue_capacity": 8, "workers": 2, "dead_workers": 0, "report_staleness_s": 0.25,
                "sync": {"sync_lag_steps": 0, "sync_lag_s": 0.0}},
    "drift": {"score": {"scores": {"ks": 0.2, "psi": 0.3, "hh_churn": None, "cardinality_ratio": 1.01},
                        "active": True, "windows": 3, "checks": 7}},
    "slices": {"acc": {"top": [{"slice": 4, "rows": 12, "values": {"": 0.5}}], "other": {"slices": 2, "rows": 3},
                       "quarantined_rows": 1, "discarded_rows": 0}},
    "metrics": {"Accuracy": {"faults": {"nonfinite_preds": 2}, "sync_lag_steps": 1, "staleness_s": 0.5}},
}


def test_merged_and_exports_equal_jax():
    ours = trm.merged(_fill(trm, 0), _fill(trm, 1))
    ref = jrm.merged(_fill(jrm, 0), _fill(jrm, 1))
    assert ours.counters() == ref.counters() and ours.gauges() == ref.gauges()
    for name in ("serve_update_ms", "snapshot_save_ms"):
        assert ours.histograms()[name].quantiles() == ref.histograms()[name].quantiles()
        assert ours.histograms()[name].count == ref.histograms()[name].count
    text_ours = mtt.obs.prometheus_text(HEALTH, ours)
    text_ref = mt.obs.prometheus_text(HEALTH, ref)
    assert text_ours == text_ref
    assert "metrics_tpu_drift_ks{monitor=\"score\"} 0.2" in text_ours
    assert json.loads(mtt.obs.json_text(HEALTH, ours)) == json.loads(mt.obs.json_text(HEALTH, ref))


def test_exit_scrape_reads_no_card_resident_sketch():
    class _CardSketch:
        class items:  # noqa: N801 - stands in for a tensor on the card
            class device:  # noqa: N801
                type = "cuda"

            @staticmethod
            def cpu():
                raise AssertionError("read the card at exit")

    reg = _fill(trm, 0)
    reg.histograms()["serve_update_ms"]._sketch = _CardSketch()
    with trm.host_only_reads():
        text = mtt.obs.prometheus_text(None, reg)
    assert "metrics_tpu_serve_update_ms_count 3000" in text
    assert 'metrics_tpu_serve_update_ms{quantile="0.5"}' not in text
    assert 'metrics_tpu_snapshot_save_ms{quantile="0.5"}' in text


def test_flight_records_dump_load_prune_and_refuse_corruption(tmp_path):
    rec = tflight.FlightRecorder(str(tmp_path), keep=2, min_interval_s=0.0)
    tflight.install_flight_recorder(rec)
    token = tflight.attach_source("serve:x", lambda: {"serving": {"offered": 3}})
    paths = [rec.dump(f"manual_{i}", "test") for i in range(3)]
    assert all(paths) and rec.stats() == {"dumps": 3, "failed": 0}
    loaded = tflight.load_flight_records(str(tmp_path))
    assert [r["trigger"]["kind"] for r in loaded] == ["manual_2", "manual_1"]
    assert loaded[0]["sources"]["serve:x"] == {"serving": {"offered": 3}}
    # the JAX package reads the port's dumps (the same format)
    assert jflight.load_flight_record(paths[-1])["trigger"]["kind"] == "manual_2"
    # a degraded edge dumps off-thread; a milestone never does
    thealth.record_degradation("gather_degraded", "peer wedged")
    thealth.record_degradation("drift_baseline_loaded", "milestone")
    rec.flush()
    kinds = [r["trigger"]["kind"] for r in tflight.load_flight_records(str(tmp_path))]
    assert kinds[0] == "gather_degraded" and "drift_baseline_loaded" not in kinds
    # corruption: refused by name, skipped by the directory load
    doc = json.loads(open(paths[-1]).read())
    doc["payload"]["pid"] = -1
    with open(paths[-1], "w") as f:
        json.dump(doc, f)
    with pytest.raises(tflight.FlightRecordError, match="checksum"):
        tflight.load_flight_record(paths[-1])
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert [r["trigger"]["kind"] for r in tflight.load_flight_records(str(tmp_path))] == ["gather_degraded"]
    tflight.detach_source(token)


def test_sigterm_leaves_a_shutdown_dump(tmp_path):
    code = (
        "import os, signal, time, metrics_tpu_torch as mtt\n"
        "from metrics_tpu_torch.resilience.health import record_degradation\n"
        "record_degradation('gather_degraded', 'before the signal')\n"
        "mtt.obs.active_flight_recorder().flush()\n"
        "print('armed', flush=True)\n"
        "time.sleep(60)\n"
    )
    env = dict(os.environ, METRICS_TPU_FLIGHTREC_DIR=str(tmp_path), PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "armed"
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == -signal.SIGTERM
    records = tflight.load_flight_records(str(tmp_path))
    shutdown = [r for r in records if r["trigger"]["kind"] == "shutdown"]
    assert shutdown and shutdown[0]["trigger"]["reason"] == "sigterm"
    assert "gather_degraded" in shutdown[0]["event_kinds"]


def test_telemetry_exporter_serves_one_scrape():
    trm.registry.counter("serve_offer_total").inc(5)
    with mtt.obs.TelemetryExporter(health_fn=lambda: HEALTH) as exporter:
        body = urllib.request.urlopen(exporter.url, timeout=10).read().decode()
        doc = json.loads(urllib.request.urlopen(exporter.url + ".json", timeout=10).read())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(exporter.url.replace("/metrics", "/nope"), timeout=10)
    assert exporter.url.startswith("http://127.0.0.1:")
    assert "metrics_tpu_serve_offer_total 5" in body and "metrics_tpu_serve_offered_total 10" in body
    assert doc["runtime"]["counters"]["serve_offer_total"] == 5 and doc["health"]["serving"]["offered"] == 10


def test_capture_counts_as_a_retrace_and_the_sync_counts_payload_bytes():
    trm.note_jit_retrace(metric="Accuracy", fn="update")
    assert trm.registry.counters()["metric_jit_retrace_total"] == 1
    from tests.helpers.torch_twin_world import TwinWorld
    from metrics_tpu_torch.parallel.sync import fused_sync

    state = {"tp": torch.arange(4, dtype=torch.float32)}
    fused_sync([state], [{"tp": "sum"}], comm=TwinWorld())
    assert trm.registry.counters()["sync_payload_bytes"] >= 16
