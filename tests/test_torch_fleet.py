"""The port's fleet tier (``metrics_tpu_torch/fleet/``) against the JAX
package's on the CPU.

The wire format is the JAX package's, so a view that either package encodes
decodes and folds in the other's ``Aggregator``: the tests hold a port
host's blob folded by a JAX aggregator to JAX's own fold of a JAX host's
blob of the same traffic, and the reverse, on a collection with sum, mean,
max, cat and ring states, a guarded member (``FaultCounters``), a
``QuantileSketch`` and a ``CountMinSketch``. Integer and sketch states are
bit-equal; float32 sums and means are within ``SUM_ATOL`` (summed in
another order). The aggregator's answers, staleness episodes, downstream and
drift federation, the publisher's breaker, deltas and int8 views, the trace
merge, a host → two pods → global tree over ``FleetServer`` on
``127.0.0.1``, and ``ServeLoop``'s fleet seams follow JAX's
``tests/fleet/``.
"""
import pickle
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.fleet as jfleet  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.fleet as tfleet  # noqa: E402
from metrics_tpu.fleet import wire as jwire  # noqa: E402
from metrics_tpu_torch.fleet import _env as tenv  # noqa: E402
from metrics_tpu_torch.fleet import wire as twire  # noqa: E402
from metrics_tpu_torch.resilience.health import registry as tregistry  # noqa: E402
from tests.helpers.fault_injection import (  # noqa: E402
    DeadChannel,
    DuplicatingChannel,
    FlappingChannel,
    RecordingChannel,
    ReorderingChannel,
    bitflip_blob,
    truncate_blob,
)
from tests.helpers.torch_twins import leaves  # noqa: E402

SUM_ATOL = 1e-5  # float32 sums and means of a few hundred lognormal rows, added in another order
SUM_RTOL = 1e-6
C = 4
STREAM_MEMBERS = ("sum", "mean", "max", "cat", "ring", "q", "cm")


@pytest.fixture(autouse=True)
def _clean_state():
    """The health, telemetry, trace and env states are process-wide; the
    telemetry histograms fold on the CPU here (D55)."""
    saved = mtt.obs.registry.fold_device
    mtt.obs.registry.fold_device = "cpu"
    for reset in (tregistry.clear, mt.resilience.health.registry.clear, mtt.obs.registry.reset, tfleet.reset_fleet_env_state,
                  twire.reset_wire_env_state, jfleet.reset_fleet_env_state, jwire.reset_wire_env_state):
        reset()
    yield
    for reset in (tregistry.clear, mt.resilience.health.registry.clear, mtt.obs.registry.reset, tfleet.reset_fleet_env_state,
                  twire.reset_wire_env_state, jfleet.reset_fleet_env_state, jwire.reset_wire_env_state):
        reset()
    mtt.obs.registry.fold_device = saved


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


# ----------------------------------------------------------------------
# one host's collection in either package, and its traffic
# ----------------------------------------------------------------------


class _JaxMeanState(mt.Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("avg", mt.metric.jnp.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.avg = self.avg + x.mean()

    def compute(self):
        return self.avg


class _PortMeanState(mtt.Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("avg", torch.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.avg = self.avg + x.mean()

    def compute(self):
        return self.avg


def _collection(pkg, cat=True):
    """``cat=False`` leaves out the list state, whose growth is a structural
    change that a delta view cannot carry (a full view re-bases)."""
    dev = {"device": "cpu"} if pkg is mtt else {}
    mean = _PortMeanState if pkg is mtt else _JaxMeanState
    members = {
        "sum": pkg.SumMetric(**dev), "mean": mean(**dev), "max": pkg.MaxMetric(**dev), "cat": pkg.CatMetric(**dev),
        "ring": pkg.CatMetric(capacity=64, **dev), "q": pkg.QuantileSketch(eps=0.05, **dev),
        "cm": pkg.CountMinSketch(depth=3, width=256, **dev), "acc": pkg.Accuracy(num_classes=C, on_invalid="drop", **dev),
    }
    if not cat:
        del members["cat"]
    return pkg.MetricCollection(members)


def _host_batches(host, batches=2, n=24):
    rng = np.random.default_rng(100 + host)
    out = []
    for _ in range(batches):
        x = rng.lognormal(size=n).astype(np.float32)
        p = rng.random((n, C)).astype(np.float32)
        p[0] = np.nan  # one fault a batch
        out.append((x, p, rng.integers(0, C, n)))
    return out


def _feed(coll, pkg, host, batches=2):
    conv = torch.from_numpy if pkg is mtt else jnp.asarray
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for x, p, y in _host_batches(host, batches):
            for name in STREAM_MEMBERS:
                if name in coll:
                    coll[name].update(conv(x))
            coll["acc"].update(conv(p), conv(y))
    return coll


def _host(pkg, host, batches=2):
    return _feed(_collection(pkg), pkg, host, batches)


def _payload_leaves(payload):
    return {path: np.asarray(v) for path, v in leaves(payload).items()}


def _same_payload(ours, ref):
    """Two folded views leaf by leaf: the float32 sums and means of the
    ``sum``/``mean`` members within SUM_ATOL, everything else (counts, the
    sketches, the rings, the cat rows, the max) bit-equal."""
    a, b = _payload_leaves(ours), _payload_leaves(ref)
    assert set(a) == set(b)
    for path in a:
        x, y = a[path], b[path]
        if "last_update_unix" in path:
            continue
        assert x.shape == y.shape, path
        if y.dtype.kind in "OUS":  # inferred attributes (a mode, a flag)
            assert str(x) == str(y), path
        elif ("/sum/" in path or "/mean/" in path) and np.issubdtype(y.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=SUM_RTOL, atol=SUM_ATOL, err_msg=path)
        elif np.issubdtype(y.dtype, np.floating):
            np.testing.assert_array_equal(x.view(np.uint8) if x.ndim else x, y.view(np.uint8) if y.ndim else y, err_msg=path)
        else:
            np.testing.assert_array_equal(x.astype(np.int64), y.astype(np.int64), err_msg=path)


def _np_value(v):
    if isinstance(v, dict):
        return {k: _np_value(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same_values(ours, ref):
    a, b = _np_value(ours), _np_value(ref)
    assert set(a) == set(b)
    for k in a:
        if np.issubdtype(np.asarray(b[k]).dtype, np.floating):
            np.testing.assert_allclose(a[k], b[k], rtol=SUM_RTOL, atol=SUM_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ----------------------------------------------------------------------
# the wire
# ----------------------------------------------------------------------


def test_wire_constants_are_jax_s():
    for name in ("MAGIC", "SCHEMA_VERSION", "ENCODING", "ENCODING_INT8", "ENCODING_DELTA", "SUPPORTED_ENCODINGS", "QUANTIZE_MIN_SIZE"):
        assert getattr(twire, name) == getattr(jwire, name), name
    assert twire._checksum_tree({"a": np.arange(3)}) == jwire._checksum_tree({"a": np.arange(3)})


@pytest.mark.parametrize("encoding", ["exact", "int8"])
def test_wire_round_trip(encoding):
    coll = _host(mtt, 0)
    payload = coll.snapshot_state()
    blob = twire.encode_view(payload, host_id="host-0", seq=5, updates=6, extra={"hosts": {}}, encoding=encoding)
    header, decoded = twire.decode_view(blob)
    assert header["host_id"] == "host-0" and header["seq"] == 5 and header["updates"] == 6
    assert header["encoding"] == twire.resolve_fleet_encoding(encoding)
    # the same blob decodes in the JAX package to the same tree, bit for bit
    jheader, jdecoded = jwire.decode_view(blob)
    assert jheader == header
    a, b = _payload_leaves(decoded), _payload_leaves(jdecoded)
    assert set(a) == set(b)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg=path)
    if encoding == "exact":
        src = _payload_leaves(payload)
        for path in src:
            np.testing.assert_array_equal(a[path], src[path], err_msg=path)


def test_int8_coding_is_jax_s_bit_for_bit():
    """The int8 leaves the port encodes decode to the values JAX's own int8
    coding of the same payload decodes to; integer leaves ship raw."""
    payload = _host(mtt, 1, batches=3).snapshot_state()
    ours = twire.decode_view(twire.encode_view(payload, "h", 1, encoding="int8"))[1]
    ref = jwire.decode_view(jwire.encode_view(payload, "h", 1, encoding="int8"))[1]
    a, b = _payload_leaves(ours), _payload_leaves(ref)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg=path)
    assert len(twire.encode_view(payload, "h", 1, encoding="int8")) < len(twire.encode_view(payload, "h", 1))


def test_delta_round_trip_applies_bit_equal():
    coll = _feed(_collection(mtt, cat=False), mtt, 2)
    base = coll.snapshot_state()
    _, digests = twire.delta_changes(base, {})
    _feed(coll, mtt, 3, batches=1)
    full = coll.snapshot_state()
    changed, _ = twire.delta_changes(full, digests)
    assert changed and len(changed) < len(digests)
    blob = twire.encode_delta_view(changed, base_seq=1, host_id="h", seq=2)
    header, payload = twire.decode_view(blob)
    assert header["encoding"] == twire.ENCODING_DELTA and twire.is_delta_payload(payload)
    rebuilt = twire.apply_delta(base, payload)
    assert twire._checksum_tree(rebuilt) == twire._checksum_tree(full)
    # the JAX package applies the port's delta to the same tree
    assert jwire._checksum_tree(jwire.apply_delta(base, jwire.decode_view(blob)[1])) == twire._checksum_tree(full)
    with pytest.raises(twire.WireError, match="absent from the held base"):
        twire.apply_delta({"x": np.zeros(1)}, payload)
    # a structural change refuses to diff
    assert twire.delta_changes({"other": np.zeros(1)}, digests)[0] is None


def test_refusals_name_the_host_and_the_leaf_as_jax():
    payload = _host(mtt, 0).snapshot_state()
    blob = twire.encode_view(payload, host_id="host-7", seq=3)
    flipped = bitflip_blob(blob, position=len(blob) - 8)
    for decode in (twire.decode_view, jwire.decode_view):
        with pytest.raises(Exception, match=r"host='host-7'.*leaf") as err:
            decode(flipped)
        assert "WireCorruptionError" in type(err.value).__name__
    with pytest.raises(twire.WireCorruptionError, match="truncated or corrupt"):
        twire.decode_view(truncate_blob(blob))
    with pytest.raises(twire.WireCorruptionError, match="magic"):
        twire.decode_view(pickle.dumps({"magic": "nope"}))
    record = pickle.loads(blob)
    record["schema_version"] = twire.SCHEMA_VERSION + 1
    with pytest.raises(twire.WireSchemaError, match="schema version"):
        twire.decode_view(pickle.dumps(record))
    record = pickle.loads(blob)
    record["checksums"] = 17
    with pytest.raises(twire.WireCorruptionError, match="checksum manifest"):
        twire.decode_view(pickle.dumps(record))
    record = pickle.loads(twire.encode_view({"states": {}}, host_id="h", seq=1))
    record["payload"] = {1: "x", "a": "y"}
    with pytest.raises(twire.WireCorruptionError):
        twire.decode_view(pickle.dumps(record))
    record = pickle.loads(twire.encode_view({"states": {}}, host_id="h", seq=1))
    record["header"]["encoding"] = "zstd-v9"
    record["checksums"] = twire._checksum_tree({"header": record["header"], "payload": record["payload"]})
    with pytest.raises(twire.WireSchemaError, match="pickle-v1"):
        twire.decode_view(pickle.dumps(record))
    with pytest.raises(twire.WireError, match="host_id"):
        twire.encode_view({}, host_id="", seq=1)
    with pytest.raises(twire.WireError, match="unknown fleet encoding"):
        twire.resolve_fleet_encoding("int4")


def test_encoding_env_resolution_and_fallback(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_FLEET_ENCODING", "int8")
    twire.reset_wire_env_state()
    assert twire.resolve_fleet_encoding() == twire.ENCODING_INT8
    assert twire.resolve_fleet_encoding("exact") == twire.ENCODING
    monkeypatch.setenv("METRICS_TPU_FLEET_ENCODING", "banana")
    twire.reset_wire_env_state()
    with pytest.warns(UserWarning, match="not a known encoding"):
        assert twire.resolve_fleet_encoding() == twire.ENCODING
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert twire.resolve_fleet_encoding() == twire.ENCODING  # warned once


def test_next_seq_is_wall_clock_floored():
    assert twire.next_seq(0) >= int(time.time() * 1e6) - 10
    assert twire.next_seq(10**18) == 10**18 + 1


# ----------------------------------------------------------------------
# cross-package folds
# ----------------------------------------------------------------------


HOSTS = 3


def _fold_states(agg):
    return agg._fold().snapshot_state()


@pytest.mark.parametrize("encoding", ["exact", "int8"])
def test_port_views_fold_in_a_jax_aggregator_to_jax_s_values(encoding):
    """Port hosts' blobs folded by JAX's ``Aggregator`` equal JAX hosts'
    blobs folded by it (int8: the same coding on both sides)."""
    jagg_port, jagg_jax = jfleet.Aggregator(_collection(mt), "g"), jfleet.Aggregator(_collection(mt), "g")
    for h in range(HOSTS):
        assert jagg_port.ingest(twire.encode_view(_host(mtt, h).snapshot_state(), f"host-{h}", 1, encoding=encoding)) == "accepted"
        assert jagg_jax.ingest(jwire.encode_view(_host(mt, h).snapshot_state(), f"host-{h}", 1, encoding=encoding)) == "accepted"
    _same_payload(_fold_states(jagg_port), _fold_states(jagg_jax))
    rep_p, rep_j = _quiet(jagg_port.report), _quiet(jagg_jax.report)
    _same_values(rep_p["value"], rep_j["value"])
    assert rep_p["faults"] == rep_j["faults"] and rep_p["faults"]["acc"]["nonfinite_preds"] == 2 * HOSTS


def test_jax_views_fold_in_a_port_aggregator_to_the_port_s_values():
    """The reverse: JAX hosts' blobs folded by the port's ``Aggregator`` equal
    the port hosts' blobs folded by it, and JAX's own fold."""
    tagg_jax, tagg_port = tfleet.Aggregator(_collection(mtt), "g"), tfleet.Aggregator(_collection(mtt), "g")
    jagg = jfleet.Aggregator(_collection(mt), "g")
    for h in range(HOSTS):
        jblob = jwire.encode_view(_host(mt, h).snapshot_state(), f"host-{h}", 1)
        assert tagg_jax.ingest(jblob) == "accepted"
        assert jagg.ingest(jblob) == "accepted"
        assert tagg_port.ingest(twire.encode_view(_host(mtt, h).snapshot_state(), f"host-{h}", 1)) == "accepted"
    _same_payload(_fold_states(tagg_jax), _fold_states(tagg_port))
    _same_payload(_fold_states(tagg_jax), _fold_states(jagg))
    _same_values(_quiet(tagg_jax.report)["value"], _quiet(jagg.report)["value"])


def test_fold_equals_one_process_over_every_host():
    """A port aggregator's fold of three hosts equals one collection fed all
    of their traffic (the sketch merged in the hosts' sorted order)."""
    agg = tfleet.Aggregator(_collection(mtt), "g")
    ref = _collection(mtt)
    for h in range(HOSTS):
        agg.ingest(twire.encode_view(_host(mtt, h).snapshot_state(), f"host-{h}", 1))
        _feed(ref, mtt, h)
    rep = _quiet(agg.report)
    want = _quiet(ref.compute)
    for k in ("sum", "max", "cat", "ring", "cm", "acc"):
        np.testing.assert_allclose(_np_value(rep["value"][k]), _np_value(want[k]), rtol=SUM_RTOL, atol=SUM_ATOL, err_msg=k)
    assert rep["updates"] == sum(m.update_count for m in ref.values())


def test_multi_hop_host_pod_global():
    pods = [tfleet.Aggregator(_collection(mtt), f"pod-{p}") for p in range(2)]
    glob = tfleet.Aggregator(_collection(mtt), "global")
    flat = tfleet.Aggregator(_collection(mtt), "flat")
    for h in range(4):
        blob = twire.encode_view(_host(mtt, h).snapshot_state(), f"host-{h}", 1)
        pods[h % 2].ingest(blob)
        flat.ingest(blob)
    for _ in range(2):  # a pod re-publishing its whole view is replace-not-add
        for pod in pods:
            glob.ingest(pod.view_blob())
    rep, want = _quiet(glob.report), _quiet(flat.report)
    assert rep["updates"] == want["updates"]
    for k in ("sum", "max", "cm", "acc"):
        np.testing.assert_allclose(_np_value(rep["value"][k]), _np_value(want["value"][k]), rtol=SUM_RTOL, atol=SUM_ATOL, err_msg=k)


# ----------------------------------------------------------------------
# the aggregator's answers, against a JAX twin fed the same blobs
# ----------------------------------------------------------------------


def _acc_blob(host, seq, batches=2, pkg=mt):
    m = pkg.Accuracy(num_classes=C, on_invalid="drop", **({"device": "cpu"} if pkg is mtt else {}))
    conv = torch.from_numpy if pkg is mtt else jnp.asarray
    for _, p, y in _host_batches(host, batches):
        _quiet(m.update, conv(p), conv(y))
    return twire.encode_view(m.snapshot_state(), f"host-{host}", seq, updates=m.update_count)


def test_ingest_answers_equal_jax_s():
    """accepted, duplicate:<held>, an older seq, a delta's rebase:none and
    rebase:<held>, a refused corrupt blob: the same answers and the same
    held views in both packages."""
    proto = lambda pkg: pkg.Accuracy(num_classes=C, on_invalid="drop", **({"device": "cpu"} if pkg is mtt else {}))  # noqa: E731
    tagg, jagg = tfleet.Aggregator(proto(mtt), "pod"), jfleet.Aggregator(proto(mt), "pod")
    src = mtt.Accuracy(num_classes=C, on_invalid="drop", device="cpu")
    _quiet(src.update, torch.from_numpy(_host_batches(9)[0][1]), torch.from_numpy(_host_batches(9)[0][2]))
    base = src.snapshot_state()
    _, digests = twire.delta_changes(base, {})
    _quiet(src.update, torch.from_numpy(_host_batches(9)[1][1]), torch.from_numpy(_host_batches(9)[1][2]))
    changed, _ = twire.delta_changes(src.snapshot_state(), digests)
    blobs = [
        twire.encode_delta_view(changed, base_seq=10, host_id="host-9", seq=11),  # rebase:none
        twire.encode_view(base, "host-9", 10),  # accepted
        twire.encode_delta_view(changed, base_seq=9, host_id="host-9", seq=12),  # rebase:10
        twire.encode_delta_view(changed, base_seq=10, host_id="host-9", seq=12),  # accepted (rebuilt)
        twire.encode_view(base, "host-9", 12),  # duplicate:12
        twire.encode_view(base, "host-9", 7),  # older: duplicate:12
        _acc_blob(0, 5, pkg=mtt),
        _acc_blob(0, 5, pkg=mt),  # same seq from the other package: duplicate:5
    ]
    answers = [(tagg.ingest(b), jagg.ingest(b)) for b in blobs]
    assert [a for a, _ in answers] == [b for _, b in answers]
    assert [a for a, _ in answers] == ["rebase:none", "accepted", "rebase:10", "accepted", "duplicate:12", "duplicate:12", "accepted", "duplicate:5"]
    bad = bitflip_blob(_acc_blob(1, 1), position=len(_acc_blob(1, 1)) - 8)
    for agg in (tagg, jagg):
        with pytest.raises(Exception, match="leaf"):
            agg.ingest(bad, source="10.0.0.1")
    assert tagg.stats() == jagg.stats() == {"hosts": 2, "accepted": 3, "duplicates": 3, "rejected": 1}
    _same_payload(_fold_states(tagg), _fold_states(jagg))
    assert _quiet(tagg.report)["value"] == pytest.approx(float(_quiet(jagg.report)["value"]), abs=0)
    events = tregistry.events("fleet_payload_rejected")
    assert len(events) == 1 and "10.0.0.1" in events[0]["details"]["host"]


def test_config_mismatch_refused_naming_host():
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), "pod")
    wrong = mtt.MeanMetric(device="cpu")
    wrong.update(torch.ones(3))
    with pytest.raises(twire.WireError, match="host-x.*does not match"):
        agg.ingest(twire.encode_view(wrong.snapshot_state(), "host-x", 1))
    assert agg.stats()["rejected"] == 1


def test_duplicate_and_reordered_delivery_folds_once():
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, on_invalid="drop", device="cpu"), "pod")
    DuplicatingChannel(agg.ingest, times=3)(_acc_blob(0, 1))
    chan = ReorderingChannel(agg.ingest, group=2)
    chan(_acc_blob(1, 1, batches=1))
    chan(_acc_blob(1, 2, batches=2))
    rep = _quiet(agg.report)
    assert rep["updates"] == 4 and agg.stats()["hosts"] == 2
    assert agg._views["host-1"]["seq"] == 2


def test_staleness_episodes_and_events_equal_jax_s():
    """A dead host is loudly stale once per episode; a fresh view ends the
    episode; a dead leaf behind a healthy pod counts in downstream_stale —
    the same reports and events in both packages."""
    out = {}
    for pkg, fleet, reg in ((mtt, tfleet, tregistry), (mt, jfleet, mt.resilience.health.registry)):
        proto = lambda: pkg.Accuracy(num_classes=C, on_invalid="drop", **({"device": "cpu"} if pkg is mtt else {}))  # noqa: E731
        agg = fleet.Aggregator(proto(), "global", stale_after_s=0.05)
        agg.ingest(_acc_blob(0, 1))
        time.sleep(0.12)
        first = _quiet(agg.report)
        _quiet(agg.report)
        agg.ingest(_acc_blob(0, 2))
        second = _quiet(agg.report)
        pod = fleet.Aggregator(proto(), "pod-0", stale_after_s=0.05)
        root = fleet.Aggregator(proto(), "root", stale_after_s=10.0)
        pod.ingest(_acc_blob(1, 1))
        time.sleep(0.12)
        root.ingest(pod.view_blob())
        rrep = _quiet(root.report)
        out[pkg.__name__] = {
            "first": (first["hosts"]["host-0"]["stale"], first["hosts_stale"]),
            "second": (second["hosts"]["host-0"]["stale"], second["hosts_stale"]),
            "root": (rrep["hosts_stale"], rrep["downstream_stale"], rrep["downstream"]["host-1"]["stale"], rrep["downstream"]["host-1"]["via"]),
            "events": sorted((e["details"].get("node_id"), e["details"].get("host")) for e in reg.events("fleet_host_stale")),
            "scrape": 'metrics_tpu_fleet_downstream_stale{node="root"} 1' in root.scrape(),
        }
    assert out["metrics_tpu_torch"] == out["metrics_tpu"]
    assert out["metrics_tpu_torch"]["first"] == (True, 1) and out["metrics_tpu_torch"]["second"] == (False, 0)


def test_drift_scores_federate_to_the_root():
    """A host's drift scores ride its header extra; the pod forwards them and
    the root's scrape names the leaf host, as JAX's does."""
    extra = {"drift": {"score": {"ks": 0.3, "psi": 0.5, "active": True}}}
    m = mtt.Accuracy(num_classes=C, device="cpu")
    _quiet(m.update, torch.tensor([0, 1]), torch.tensor([0, 1]))
    blob = twire.encode_view(m.snapshot_state(), "host-3", 1, extra=extra)
    texts = []
    for fleet, proto in ((tfleet, lambda: mtt.Accuracy(num_classes=C, device="cpu")), (jfleet, lambda: mt.Accuracy(num_classes=C))):
        pod, root = fleet.Aggregator(proto(), "pod-0"), fleet.Aggregator(proto(), "root")
        pod.ingest(blob)
        root.ingest(pod.view_blob())
        assert root.report()["downstream"]["host-3"]["drift"] == extra["drift"]
        texts.append(sorted(line for line in root.scrape().splitlines() if "fleet_host_drift" in line and not line.startswith("#")))
    assert texts[0] == texts[1] and any('host="host-3"' in line and 'via="pod-0"' in line for line in texts[0])


def test_empty_aggregator_reports_and_scrapes():
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), "empty")
    rep = agg.report()
    assert rep["value"] is None and rep["updates"] == 0 and agg.fleet_view() is None and agg.view_blob() is None
    assert 'metrics_tpu_fleet_hosts{node="empty"} 0' in agg.scrape()
    assert '"fleet"' in agg.scrape("json")
    with pytest.raises(mtt.utilities.exceptions.MetricsTPUUserError):
        agg.scrape("xml")
    with pytest.raises(mtt.utilities.exceptions.MetricsTPUUserError):
        tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), node_id="")


def test_fold_cache_reuses_between_ingests():
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, on_invalid="drop", device="cpu"), "g")
    agg.ingest(_acc_blob(0, 1))
    assert agg._fold() is agg._fold()
    agg.ingest(_acc_blob(1, 1))
    assert agg.report()["updates"] == 4


# ----------------------------------------------------------------------
# the publisher
# ----------------------------------------------------------------------


def _metric(seed=0):
    m = mtt.Accuracy(num_classes=C, device="cpu")
    rng = np.random.default_rng(seed)
    _quiet(m.update, torch.from_numpy(rng.integers(0, C, 32)), torch.from_numpy(rng.integers(0, C, 32)))
    return m


def test_metric_source_publishes_on_cadence():
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), "global")
    channel = RecordingChannel(agg.ingest)
    m = _metric()
    pub = tfleet.FleetPublisher(m, channel, host_id="host-0", publish_every_s=0.05, deadline_s=2.0)
    try:
        deadline = time.monotonic() + 5.0
        while channel.calls < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        pub.stop()
    assert channel.calls >= 2 and agg.stats()["hosts"] == 1
    assert float(agg.report()["value"]) == float(m.compute())


def test_dead_destination_opens_its_breaker_and_goes_stale():
    """A dead destination fails bounded, opens its own breaker (the healthy
    one keeps receiving), records fleet_publish_error and one
    fleet_host_stale; a flapping one recovers with fleet_publish_recovered."""
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), "pod")
    dead, ok = DeadChannel(), RecordingChannel(agg.ingest)
    pub = tfleet.FleetPublisher(_metric(), {"dead": dead, "ok": ok}, host_id="h", deadline_s=1.0, max_retries=1,
                                backoff_s=0.01, breaker_cooldown_s=30.0, stale_after_s=0.05, start=False)
    out = pub.publish_now()
    assert out["ok"] == "ok" and out["dead"].startswith("failed:")
    time.sleep(0.1)
    out = pub.publish_now()
    assert out == {"dead": "skipped:circuit_open", "ok": "ok"}
    stats = pub.stats()
    assert stats["dead"]["circuit_open"] and not stats["ok"]["circuit_open"] and stats["dead"]["failed"] == 1
    assert len(tregistry.events("fleet_publish_error")) == 1
    assert len(tregistry.events("fleet_host_stale")) == 1
    pub.stop(flush=False)
    flap = FlappingChannel(fail_times=2, sink=agg.ingest)
    pub = tfleet.FleetPublisher(_metric(1), flap, host_id="h2", deadline_s=1.0, max_retries=0, backoff_s=0.01,
                                breaker_cooldown_s=0.05, stale_after_s=0.05, start=False)
    assert pub.publish_now()["default"].startswith("failed:")
    time.sleep(0.1)
    pub.publish_now()  # the breaker's cooldown passed: a probe, failed again
    time.sleep(0.1)
    assert pub.publish_now()["default"] == "ok"
    assert len(tregistry.events("fleet_publish_recovered")) == 1
    pub.stop(flush=False)


def test_publisher_deltas_int8_and_rebase():
    """Full then delta views, each folded bit-equal to a full publish; an
    aggregator restart answers rebase, records fleet_delta_rebase once, and
    the next pass re-ships a full view; int8 deltas fold like int8 fulls."""
    src = _collection(mtt, cat=False)
    _feed(src, mtt, 0)
    agg = tfleet.Aggregator(_collection(mtt, cat=False), "pod")
    box = {"agg": agg}
    pub = tfleet.FleetPublisher(src, lambda b: box["agg"].ingest(b), host_id="h", delta=True, start=False)
    assert pub.publish_now() == {"default": "ok"}
    _feed(src, mtt, 1, batches=1)
    pub.publish_now()
    counters = mtt.obs.registry.counters()
    assert counters["fleet_publish_full_total"] == 1 and counters["fleet_publish_delta_total"] == 1
    twire_full = src.snapshot_state()
    _same_payload(agg._views["h"]["payload"], twire_full)
    box["agg"] = tfleet.Aggregator(_collection(mtt, cat=False), "pod")  # restart
    _feed(src, mtt, 2, batches=1)
    pub.publish_now()  # a delta against a base the new node never held
    assert box["agg"].stats()["hosts"] == 0 and len(tregistry.events("fleet_delta_rebase")) == 1
    pub.publish_now()  # full re-ship
    assert box["agg"].stats()["hosts"] == 1
    _same_payload(box["agg"]._views["h"]["payload"], src.snapshot_state())
    # delta x int8 folds bit-equal to a full int8 publish of the same view
    a8, f8 = tfleet.Aggregator(_collection(mtt, cat=False), "a"), tfleet.Aggregator(_collection(mtt, cat=False), "f")
    pub8 = tfleet.FleetPublisher(src, a8.ingest, host_id="h8", delta=True, encoding="int8", start=False)
    pub8.publish_now()
    _feed(src, mtt, 3, batches=1)
    pub8.publish_now()
    f8.ingest(twire.encode_view(src.snapshot_state(), "h8", 1, encoding="int8"))
    assert twire._checksum_tree(a8._views["h8"]["payload"]) == twire._checksum_tree(f8._views["h8"]["payload"])


def test_idle_publishes_reuse_the_held_view_and_the_fold():
    """An idle host's delta changes no leaf: the aggregator keeps its held
    snapshot and folded reporter (no clone, no device copy, no re-fold) and
    its next publish reads nothing back, while a changed view re-folds."""
    src = _metric()
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), "pod")
    pub = tfleet.FleetPublisher(src, agg.ingest, host_id="h", delta=True, start=False)
    pub.publish_now()
    snap, reporter = agg._views["h"]["snap"], agg._fold()
    view = agg.fleet_view()
    assert pub.publish_now() == {"default": "ok"} and agg.stats()["accepted"] == 2
    assert agg._views["h"]["snap"] is snap and agg._fold() is reporter and agg.fleet_view() is view
    _quiet(src.update, torch.tensor([0, 1]), torch.tensor([1, 1]))
    pub.publish_now()
    assert agg._views["h"]["snap"] is not snap and agg._fold() is not reporter
    assert float(agg.report()["value"]) == float(src.compute())


def test_seq_regression_jumps_after_three_duplicates():
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), "pod")
    future = twire.next_seq(0) + 10**12
    agg.ingest(twire.encode_view(_metric().snapshot_state(), "h", future))
    pub = tfleet.FleetPublisher(_metric(), agg.ingest, host_id="h", start=False)
    for _ in range(3):
        pub.publish_now()
    assert len(tregistry.events("fleet_seq_regression")) == 1
    pub.publish_now()
    assert agg._views["h"]["seq"] > future


def test_env_knobs_resolve_and_warn_once(monkeypatch):
    assert tenv.resolve_fleet_knob("stale_after_s", 3.0) == 3.0
    monkeypatch.setenv("METRICS_TPU_FLEET_STALE_AFTER_S", "2.5")
    tenv.reset_fleet_env_state()
    assert tenv.resolve_fleet_knob("stale_after_s", None) == 2.5
    monkeypatch.setenv("METRICS_TPU_FLEET_STALE_AFTER_S", "nan")
    tenv.reset_fleet_env_state()
    with pytest.warns(UserWarning, match="not a positive number"):
        assert tenv.resolve_fleet_knob("stale_after_s", None) == tenv.DEFAULT_STALE_AFTER_S
    with pytest.raises(ValueError):
        tenv.resolve_fleet_knob("deadline_s", float("nan"))
    monkeypatch.setenv("METRICS_TPU_FLEET_DELTA", "yes")
    assert tenv.resolve_fleet_delta() is True and tenv.resolve_fleet_delta(False) is False
    monkeypatch.setenv("METRICS_TPU_FLEET_DELTA", "maybe")
    tenv.reset_fleet_env_state()
    with pytest.warns(UserWarning, match="boolean token"):
        assert tenv.resolve_fleet_delta() is False
    with pytest.raises(mtt.utilities.exceptions.MetricsTPUUserError):
        tfleet.FleetPublisher(object(), RecordingChannel(), host_id="h")
    with pytest.raises(mtt.utilities.exceptions.MetricsTPUUserError):
        tfleet.FleetPublisher(_metric(), {}, host_id="h")


def test_trace_sections_merge_at_the_aggregator():
    """With tracing on, a publish ships the host's new spans once (the
    watermark), and the aggregator's merged trace holds one copy of each
    under the host's process; the fold links to the publish span."""
    with mtt.obs.force_tracing(True):
        mtt.obs.clear_trace()
        agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), "pod")
        m = _metric()
        pub = tfleet.FleetPublisher(m, agg.ingest, host_id="host-t", start=False)
        with mtt.obs.span("host.work"):
            pass
        pub.publish_now()
        pub.publish_now()
        agg.report()
        doc = agg.fleet_trace()
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    section = agg._trace_sections["host-t"]
    assert sum(1 for ev in section["events"] if ev.get("name") == "host.work" and ev.get("ph") == "X") == 1
    assert any(ev.get("name") == "fleet.fold" for ev in events)
    assert agg._last_trace_ctx is not None


# ----------------------------------------------------------------------
# over HTTP: host -> two pods -> global
# ----------------------------------------------------------------------


def test_tree_over_fleet_server_equals_one_process():
    """Four port hosts publish over HTTP on 127.0.0.1 to two pods, each pod
    to one global: the global value equals one process that saw every
    host's traffic; a bit-flipped blob answers HTTP 400 naming the leaf."""
    proto = lambda: mtt.Accuracy(num_classes=C, on_invalid="drop", device="cpu")  # noqa: E731
    glob = tfleet.Aggregator(proto(), "global")
    pods = [tfleet.Aggregator(proto(), f"pod-{p}") for p in range(2)]
    servers = [tfleet.FleetServer(a) for a in [glob] + pods]
    pubs = []
    ref = proto()
    try:
        for p, pod in enumerate(pods):
            pubs.append(tfleet.FleetPublisher(pod, servers[0].channel(), host_id=pod.node_id, start=False))
        host_pubs = []
        for h in range(4):
            m = proto()
            for _, p_, y in _host_batches(h):
                _quiet(m.update, torch.from_numpy(p_), torch.from_numpy(y))
                _quiet(ref.update, torch.from_numpy(p_), torch.from_numpy(y))
            host_pubs.append(tfleet.FleetPublisher(m, servers[1 + h % 2].channel(), host_id=f"host-{h}", start=False, delta=True))
        for pub in host_pubs:
            assert pub.publish_now() == {"default": "ok"}
        for pub in pubs:
            assert pub.publish_now() == {"default": "ok"}
        rep = glob.report()
        assert float(rep["value"]) == float(_quiet(ref.compute)) and rep["updates"] == ref.update_count
        assert rep["faults"]["Accuracy"] == ref.fault_counts
        import urllib.error
        import urllib.request

        text = urllib.request.urlopen(servers[0].url + "/metrics", timeout=10).read().decode()
        assert 'host="host-3"' in text and 'via="pod-1"' in text
        assert b"traceEvents" in urllib.request.urlopen(servers[0].url + "/trace.json", timeout=10).read()
        blob = twire.encode_view(ref.snapshot_state(), "host-9", 1)
        with pytest.raises(urllib.error.HTTPError) as err:
            servers[1].channel()(bitflip_blob(blob, position=len(blob) - 8))
        assert err.value.code == 400 and b"leaf" in err.value.read()
    finally:
        for s in servers:
            s.close()


# ----------------------------------------------------------------------
# ServeLoop's fleet seams
# ----------------------------------------------------------------------


def test_serve_loop_feeds_a_publisher():
    """``fleet_view`` is the last reporter's snapshot, ``fleet_trace_context``
    the reduce's context and ``fleet_extra`` the drift monitors' scores: a
    served loop publishes its merged value."""
    proto = mtt.Accuracy(num_classes=C, on_invalid="drop", device="cpu")
    mon = mtt.DriftMonitor("conf", window=256, eps=0.05, device="cpu")
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, on_invalid="drop", device="cpu"), "pod")
    loop = mtt.ServeLoop(proto, workers=2, reduce_every_s=0.05, drift_monitors=[mon])
    try:
        assert loop.fleet_view() is None
        for h in range(3):
            for _, p, y in _host_batches(h):
                assert loop.offer(torch.from_numpy(p), torch.from_numpy(y))
        loop.drain()
        view = loop.report(fresh=True, deadline_s=30)
        assert view["fresh"]
        extra = loop.fleet_extra()
        assert set(extra) == {"drift"} and set(extra["drift"]) == {"conf"}
        reporter = loop._last_reporter
        payload = loop.fleet_view()  # one read back a reporter: publishes until the next reduce share it
        assert loop._last_reporter is not reporter or loop.fleet_view() is payload
        with mtt.obs.force_tracing(True):
            loop.report(fresh=True, deadline_s=30)
        pub = tfleet.FleetPublisher(loop, agg.ingest, host_id="host-s", start=False)
        assert pub.publish_now() == {"default": "ok"}
        rep = agg.report()
        assert float(rep["value"]) == float(view["value"]) and rep["updates"] == view["updates"] == 6
        # the monitor's scores as the publish read them (a check on the
        # reducer's tick may have moved them since `extra` was read)
        held = agg._views["host-s"]["drift"]
        assert set(held) == {"conf"} and set(held["conf"]) == set(extra["drift"]["conf"])
    finally:
        loop.stop()


def test_publisher_never_blocks_on_a_wedged_destination():
    """The cadence thread pushes on a worker per destination: a wedged one is
    skipped as in flight, the healthy one keeps receiving."""
    gate = threading.Event()
    agg = tfleet.Aggregator(mtt.Accuracy(num_classes=C, device="cpu"), "pod")

    def wedged(blob):
        gate.wait(5.0)
        return "accepted"

    pub = tfleet.FleetPublisher(_metric(), {"slow": wedged, "ok": agg.ingest}, host_id="h", deadline_s=5.0, start=False)
    first = pub.publish_now(wait=False)
    assert first == {"slow": "spawned", "ok": "spawned"} or first["slow"] == "spawned"
    second = pub.publish_now(wait=False)
    assert second["slow"] == "skipped:inflight"
    gate.set()
    pub.stop(flush=False)
    deadline = time.monotonic() + 5
    while agg.stats()["hosts"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert agg.stats()["hosts"] == 1
