"""Crash-recovery snapshots of the port (``Metric.snapshot_state``,
``load_snapshot_state`` and the collection's forms), and their interop with
the JAX package in both directions.

A payload is plain data: numpy leaves, a ``CatBuffer`` ring as a ``{data,
mask, dropped}`` dict, ``FaultCounters`` as their counts vector (uint32 in
JAX, int64 here: D11), a sketch state as its primitives, the update count,
the clock, the attributes an update inferred and, recursively, the child
metrics' snapshots. A payload written by either package loads into the
other, and both then compute the same value from it and from the batches
that follow (exact for counts, ``SUM_ATOL`` for float32 values summed in
another order). A payload that does not fit is refused before anything of
the tree changes.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch.utilities.enums import DataType  # noqa: E402
from tests.test_torch_classification import _np  # noqa: E402

SUM_ATOL = 1e-6
C = 4
N = 36


def _batch(kind, seed, n=N):
    rng = np.random.default_rng(seed)
    if kind == "scores":
        return rng.random(n).astype(np.float32), rng.integers(0, 2, n)
    if kind == "probs":
        p = rng.random((n, C)).astype(np.float32)
        p[::9] = np.nan  # faults for the guarded metrics
        return p, rng.integers(0, C, n)
    if kind == "stream":
        return (rng.lognormal(size=n).astype(np.float32),)
    if kind == "multilabel":
        return rng.random((n, C)).astype(np.float32), rng.integers(0, 2, (n, C))
    if kind == "dists":
        return rng.random((n, C)).astype(np.float32) + 0.1, rng.random((n, C)).astype(np.float32) + 0.1
    return rng.integers(0, C, n), rng.integers(0, C, n)


# (name, kwargs, kind): one of each state kind
CASES = [
    ("ConfusionMatrix", dict(num_classes=C), "labels"),  # an int32 tensor
    ("Accuracy", dict(num_classes=C), "labels"),  # attrs: mode, subset_accuracy
    ("AUROC", dict(capacity=64), "scores"),  # two rings
    ("CalibrationError", dict(), "scores"),  # lists
    ("KLDivergence", dict(reduction="none", capacity=128), "dists"),  # a float ring
    ("Precision", dict(num_classes=C, average="macro", on_invalid="warn"), "probs"),  # fault counters
    ("QuantileSketch", dict(eps=0.05), "stream"),  # a sketch state
]


def _feed(metric, pkg, kind, seeds):
    conv = torch.from_numpy if pkg is mtt else jnp.asarray
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for s in seeds:
            metric.update(*(conv(a) for a in _batch(kind, s)))


def _value(metric):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return metric.compute()


def _close(ours, ref):
    if isinstance(ref, (list, tuple)):
        for o, r in zip(ours, ref):
            _close(o, r)
        return
    o, r = _np(ours), np.asarray(ref)
    assert o.shape == r.shape
    if np.issubdtype(r.dtype, np.floating):
        np.testing.assert_allclose(o, r, rtol=0, atol=SUM_ATOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(o, r)


def _build(pkg, name, kwargs):
    return getattr(pkg, name)(**kwargs, **({"device": "cpu"} if pkg is mtt else {}))


@pytest.mark.parametrize(("name", "kwargs", "kind"), CASES, ids=[c[0] for c in CASES])
def test_jax_snapshot_loads_into_the_port(name, kwargs, kind):
    ref, ours = _build(mt, name, kwargs), _build(mtt, name, kwargs)
    _feed(ref, mt, kind, (0, 1))
    payload = ref.snapshot_state()
    ours.load_snapshot_state(payload)
    assert ours.update_count == ref.update_count == 2 and ours._last_update_unix == payload["last_update_unix"]
    if "attrs" in payload and "mode" in payload["attrs"]:
        assert isinstance(ours.mode, DataType) and ours.mode.value == payload["attrs"]["mode"].value
    _close(_value(ours), _value(ref))
    _feed(ref, mt, kind, (2,))
    _feed(ours, mtt, kind, (2,))
    _close(_value(ours), _value(ref))


@pytest.mark.parametrize(("name", "kwargs", "kind"), CASES, ids=[c[0] for c in CASES])
def test_port_snapshot_loads_into_jax_and_back(name, kwargs, kind):
    ours, ref = _build(mtt, name, kwargs), _build(mt, name, kwargs)
    _feed(ours, mtt, kind, (0, 1))
    payload = ours.snapshot_state()
    leaves = [v for v in payload["states"].values()]
    assert all(isinstance(x, (np.ndarray, list, dict)) for x in leaves)
    ref.load_snapshot_state(payload)
    _close(_value(ours), _value(ref))
    _feed(ours, mtt, kind, (2,))
    _feed(ref, mt, kind, (2,))
    _close(_value(ours), _value(ref))
    # and back: a fresh port metric from the JAX metric's snapshot
    again = _build(mtt, name, kwargs)
    again.load_snapshot_state(ref.snapshot_state())
    _close(_value(again), _value(ours))


def test_snapshot_covers_a_composition_tree_and_a_collection():
    def f1(pkg, **dev):
        p = pkg.Precision(num_classes=C, average="macro", **dev)
        r = pkg.Recall(num_classes=C, average="macro", **dev)
        return 2 * p * r / (p + r)

    ours, ref = f1(mtt, device="cpu"), f1(mt)
    _feed(ours, mtt, "labels", (0, 1))
    payload = ours.snapshot_state()
    assert set(payload["children"]) == {"metric_a", "metric_b"}
    ref.load_snapshot_state(payload)
    _close(_value(ref), _value(ours))
    fresh = f1(mtt, device="cpu")
    fresh.load_snapshot_state(ref.snapshot_state())
    _close(_value(fresh), _value(ours))

    def coll(pkg, **dev):
        return pkg.MetricCollection({"cm": pkg.ConfusionMatrix(C, **dev), "kappa": pkg.CohenKappa(C, **dev), "acc": pkg.Accuracy(num_classes=C, **dev)})

    ours_c, ref_c = coll(mtt, device="cpu"), coll(mt)
    for s in (0, 1):
        ours_c.update(*(torch.from_numpy(a) for a in _batch("labels", s)))
        ref_c.update(*(jnp.asarray(a) for a in _batch("labels", s)))
    back = coll(mtt, device="cpu")
    back.load_snapshot_state(ref_c.snapshot_state())
    ref_back = coll(mt)
    ref_back.load_snapshot_state(ours_c.snapshot_state())
    want = ours_c.compute()
    for got in (back.compute(), ref_back.compute()):
        for k in want:
            _close(got[k], want[k])


def test_windowed_snapshot_carries_its_wrapped_child():
    ours = mtt.WindowedMetric(mtt.Accuracy(num_classes=C, device="cpu"), window=32, buckets=4)
    _feed(ours, mtt, "labels", (0, 1))
    payload = ours.snapshot_state()
    assert "wrapped" in payload["children"]
    fresh = mtt.WindowedMetric(mtt.Accuracy(num_classes=C, device="cpu"), window=32, buckets=4)
    fresh.load_snapshot_state(payload)
    _close(fresh.compute(), ours.compute())


def test_a_refused_snapshot_changes_nothing_in_the_tree():
    p, r = mtt.Precision(num_classes=C, average="macro", device="cpu"), mtt.Recall(num_classes=C, average="macro", device="cpu")
    f1 = 2 * p * r / (p + r)
    _feed(f1, mtt, "labels", (0,))
    good, good_count = f1.snapshot_state(), p.update_count
    _feed(f1, mtt, "labels", (1, 2))
    live = (_np(p.metric_state["tp"]).copy(), _np(r.metric_state["tp"]).copy(), p.update_count)
    # the last leaf of the tree has a state of the wrong shape: the leaves
    # validated before it must not commit either
    bad = good.copy()
    bad["children"] = {k: v for k, v in good["children"].items()}
    right = dict(good["children"]["metric_b"])
    right["children"] = dict(right["children"])
    recall = dict(right["children"]["metric_b"])
    recall["states"] = {**recall["states"], "tp": np.zeros(C + 1, np.int32)}
    right["children"]["metric_b"] = recall
    bad["children"]["metric_b"] = right
    with pytest.raises(ValueError, match=r"Recall.load_snapshot_state: state 'tp' has shape"):
        f1.load_snapshot_state(bad)
    np.testing.assert_array_equal(_np(p.metric_state["tp"]), live[0])
    np.testing.assert_array_equal(_np(r.metric_state["tp"]), live[1])
    assert p.update_count == live[2]
    f1.load_snapshot_state(good)
    assert p.update_count == good_count and _np(p.metric_state["tp"]).sum() < live[0].sum()


@pytest.mark.parametrize(
    ("mutate", "match"),
    [
        (lambda s: s["states"].update(bogus=np.zeros(1)), "unknown state 'bogus'"),
        (lambda s: s.update(children={"nope": {}}), "child metric 'nope'"),
        (lambda s: s.update(attrs={"num_classes": 3}), "does not declare"),
        (lambda s: s["states"].update(confmat=np.zeros((C, C), np.float32)), "dtype"),
    ],
    ids=["unknown-state", "unknown-child", "undeclared-attr", "wrong-dtype"],
)
def test_validation_refuses_as_jax(mutate, match):
    ours, ref = mtt.ConfusionMatrix(C, device="cpu"), mt.ConfusionMatrix(C)
    _feed(ours, mtt, "labels", (0,))
    payload = ours.snapshot_state()
    mutate(payload)
    before = _np(ours.metric_state["confmat"]).copy()
    with pytest.raises(ValueError, match=match):
        ours.load_snapshot_state(payload)
    with pytest.raises(ValueError):
        ref.load_snapshot_state(payload)
    np.testing.assert_array_equal(_np(ours.metric_state["confmat"]), before)


def test_a_payload_shares_no_storage_with_the_live_state():
    """State ownership: updates write states in place, so a payload must
    hold copies (a numpy view of a CPU tensor would change with them)."""
    m = mtt.ConfusionMatrix(C, device="cpu")
    _feed(m, mtt, "labels", (0,))
    payload = m.snapshot_state()
    held = payload["states"]["confmat"].copy()
    _feed(m, mtt, "labels", (1,))
    np.testing.assert_array_equal(payload["states"]["confmat"], held)


def test_collection_refuses_an_unknown_member():
    coll = mtt.MetricCollection({"cm": mtt.ConfusionMatrix(C, device="cpu")})
    with pytest.raises(ValueError, match="member 'other'"):
        coll.load_snapshot_state({"members": {"other": {}}})


def test_overlapped_metric_snapshots_its_live_state():
    m = mtt.SumMetric(sync_mode="overlapped", sync_every_n=2, device="cpu")
    for s in range(3):
        m.update(torch.from_numpy(_batch("stream", s)[0]))
    payload = m.snapshot_state()
    fresh = mtt.SumMetric(device="cpu")
    fresh.load_snapshot_state(payload)
    _close(fresh.compute(), m.compute(fresh=True))
    m.reset()


@pytest.mark.parametrize(
    ("name", "kwargs", "kind"),
    [
        ("ConfusionMatrix", dict(num_classes=C, multilabel=True), "multilabel"),
        ("CalibrationError", dict(), "scores"),
        ("CalibrationError", dict(binned=True), "scores"),
        ("KLDivergence", dict(reduction="none", capacity=128), "dists"),
        ("HingeLoss", dict(), "scores"),
        ("LabelRankingLoss", dict(), "multilabel"),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_load_jax_state_carries_the_new_states(name, kwargs, kind):
    from metrics_tpu_torch.interop import load_jax_state

    ref, ours = _build(mt, name, kwargs), _build(mtt, name, kwargs)
    _feed(ref, mt, kind, (0, 1))
    state = {k: (list(v) if isinstance(v, list) else v) for k, v in ref.metric_state.items()}
    load_jax_state(ours, state)
    _close(_value(ours), _value(ref))
