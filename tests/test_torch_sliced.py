"""Sliced multi-tenancy in the port (``metrics_tpu_torch/sliced``,
``pure.py::sliced_functionalize``) against the JAX package's
``metrics_tpu/sliced`` and ``metrics_tpu/pure.py``, on the same seeded
numpy inputs.

Tolerances: integer rings (counts, fault counters, CountMin, HyperLogLog
registers, row counts) bit-equal; float rings within ``rtol=1e-6`` plus
``atol=1e-6`` (a mean ring holds float32 sums of per-row deltas, added by
``index_add`` where the JAX package runs ``segment_sum``: another order,
W4); computed values within ``atol=1e-6``.

Also held: the quarantine and discard routing, the bounded scrape and its
environment variable, ``WindowedMetric(SlicedMetric(m))``, every refusal
of the JAX package, the kernel-backed members (K1's Binned metrics and K2's
confusion family) sliced through the kernels' lane route, one lane-batched
call per update, the sliced pure layer in both modes (the
sharded one over four Gloo ranks against JAX's ``psum_scatter`` under
``jax.vmap(axis_name="data")``, its collectives counted), the fault ring
in ``MetricDef.faults``, and the sliced states carried across the packages.
"""
import multiprocessing as mp
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.sliced as jsl  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.sliced as tsl  # noqa: E402
from metrics_tpu.pure import _faults_in_state as jax_faults_in_state  # noqa: E402
from metrics_tpu.utilities.exceptions import MetricsTPUUserError as JaxUserError  # noqa: E402
from metrics_tpu_torch.interop import load_jax_pure_state, load_jax_state, to_jax_pure_state  # noqa: E402
from metrics_tpu_torch.ops import binned_counters, histogram  # noqa: E402
from metrics_tpu_torch.pure import _faults_in_state  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402
from tests.helpers import torch_sliced_ranks as R  # noqa: E402
from tests.helpers.torch_twins import assert_states_close, leaves  # noqa: E402

C = 4
K = 5
RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


class JaxRowStats(mt.Metric):
    """A ``"mean"`` state (the last batch's mean) and a ``"min"`` state."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("avg", default=jnp.asarray(0.0), dist_reduce_fx="mean")
        self.add_state("low", default=jnp.asarray(jnp.inf), dist_reduce_fx="min")

    def update(self, x):
        x = jnp.asarray(x, jnp.float32)
        self.avg = jnp.mean(x)
        self.low = jnp.minimum(self.low, jnp.min(x))

    def compute(self):
        return {"avg": self.avg, "low": self.low}


class TorchRowStats(mtt.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("avg", default=torch.tensor(0.0), dist_reduce_fx="mean")
        self.add_state("low", default=torch.tensor(float("inf")), dist_reduce_fx="min")

    def update(self, x):
        x = torch.as_tensor(x).to(torch.float32)
        self.avg = x.mean()
        self.low = torch.minimum(self.low, x.min())

    def compute(self):
        return {"avg": self.avg, "low": self.low}


def _rows(n, seed, nan=False):
    rng = np.random.default_rng(seed)
    p = rng.random((n, C)).astype(np.float32)
    t = rng.integers(0, C, n)
    ids = rng.integers(-1, K + 2, n)
    if nan:
        p[rng.random(n) < 0.15, 1] = np.nan
        t[rng.random(n) < 0.1] = C
    return p, t, ids


CHILDREN = {
    "acc_drop": (lambda pkg, **kw: pkg.Accuracy(num_classes=C, on_invalid="drop", **kw), "pt"),
    "prec_macro_warn": (lambda pkg, **kw: pkg.Precision(num_classes=C, average="macro", on_invalid="warn", **kw), "pt"),
    "sum": (lambda pkg, **kw: pkg.SumMetric(**kw), "x"),
    "max": (lambda pkg, **kw: pkg.MaxMetric(**kw), "x"),
    "min": (lambda pkg, **kw: pkg.MinMetric(**kw), "x"),
    "mean_min_states": (lambda pkg, **kw: (TorchRowStats if pkg is mtt else JaxRowStats)(**kw), "x"),
    "countmin": (lambda pkg, **kw: pkg.CountMinSketch(width=32, **kw), "x"),
    "hll": (lambda pkg, **kw: pkg.HyperLogLog(**kw), "x"),
    "bap_plain_version": (lambda pkg, **kw: pkg.BinnedAveragePrecision(num_classes=C, thresholds=6, **kw), "pt"),
}


def _args(kind, p, t, pkg):
    arr = jnp.asarray if pkg is mt else torch.from_numpy
    if kind == "pt":
        return (arr(p), arr(t))
    return (arr(np.nan_to_num(p[:, 0], nan=0.25).copy()),)


def _ring_states(m):
    return {k: v for k, v in m.metric_state.items() if k.startswith("sl__")}


def _close_values(ours, ref):
    a, b = leaves(ours), leaves(ref)
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(CHILDREN))
def test_rings_and_values_match_jax(name):
    factory, kind = CHILDREN[name]
    ours = mtt.SlicedMetric(factory(mtt, device="cpu"), num_slices=K)
    ref = jsl.SlicedMetric(factory(mt), num_slices=K)
    for i, n in enumerate((13, 9, 17)):
        p, t, ids = _rows(n, seed=i, nan=kind == "pt")
        valid = (np.arange(n) % 5 != 2) if i == 1 else None
        kw_t = {} if valid is None else {"valid": torch.from_numpy(valid)}
        kw_j = {} if valid is None else {"valid": jnp.asarray(valid)}
        if i == 2:
            ours(*_args(kind, p, t, mtt), slice_ids=torch.from_numpy(ids), **kw_t)
            ref(*_args(kind, p, t, mt), slice_ids=jnp.asarray(ids), **kw_j)
        else:
            ours.update(*_args(kind, p, t, mtt), slice_ids=torch.from_numpy(ids), **kw_t)
            ref.update(*_args(kind, p, t, mt), slice_ids=jnp.asarray(ids), **kw_j)
        assert_states_close(_ring_states(ours), _ring_states(ref), rtol=RTOL, atol=ATOL)
    out, want = ours.compute(), ref.compute()
    assert isinstance(out, tsl.SlicedValue)
    _close_values(out.per_slice, want.per_slice)
    _close_values(out.global_value, want.global_value)
    assert int(out.quarantined_rows) == int(want.quarantined_rows) == ours.quarantined_rows
    assert ours.discarded_rows == ref.discarded_rows
    np.testing.assert_array_equal(ours.slice_rows, np.asarray(ref.slice_rows))
    want_faults = ref.fault_counts
    assert ours.fault_counts == (None if want_faults is None else {k: int(v) for k, v in want_faults.items()})


def test_sliced_update_reads_nothing_back():
    from tests.test_torch_retrieval import ScalarReads

    m = mtt.SlicedMetric(mtt.Precision(num_classes=C, average="macro", on_invalid="drop", device="cpu"), num_slices=K,
                         pad_batches=True)
    for i, n in enumerate((9, 13)):
        p, t, ids = _rows(n, seed=60 + i, nan=True)
        args = (torch.from_numpy(p), torch.from_numpy(t))
        if i == 0:
            m.update(*args, slice_ids=torch.from_numpy(ids))  # the mode is resolved at the first update
            continue
        with ScalarReads() as rec:
            m.update(*args, slice_ids=torch.from_numpy(ids))
        assert rec.reads == 0


def test_routing_invalid_beats_out_of_range():
    ids = np.array([0, 1, K, -1, 2, K + 7, 3, 0])
    valid = np.array([1, 1, 1, 1, 0, 0, 1, 1], bool)
    x = np.arange(8, dtype=np.float32)
    ours = mtt.SlicedMetric(mtt.SumMetric(device="cpu"), num_slices=K)
    ref = jsl.SlicedMetric(mt.SumMetric(), num_slices=K)
    ours.update(torch.from_numpy(x), slice_ids=torch.from_numpy(ids), valid=torch.from_numpy(valid))
    ref.update(jnp.asarray(x), slice_ids=jnp.asarray(ids), valid=jnp.asarray(valid))
    assert ours.quarantined_rows == ref.quarantined_rows == 2
    assert ours.discarded_rows == ref.discarded_rows == 2
    assert ours.metric_state["sl__value"].tolist() == np.asarray(ref.metric_state["sl__value"]).tolist()
    assert ours.metric_state["sl__value"][K + 1] == 4 + 5
    assert float(ours.compute().global_value) == float(ref.compute().global_value) == 0 + 1 + 6 + 7


def test_scrape_slices_and_its_label_cap(monkeypatch):
    ours = mtt.SlicedMetric(mtt.Accuracy(num_classes=C, device="cpu"), num_slices=K)
    ref = jsl.SlicedMetric(mt.Accuracy(num_classes=C), num_slices=K)
    assert ours.scrape_slices()["top"] == [] and ours.scrape_slices()["other"] == {"slices": 0, "rows": 0}
    p, t, ids = _rows(40, seed=3)
    ours.update(torch.from_numpy(p), torch.from_numpy(t), slice_ids=torch.from_numpy(ids))
    ref.update(jnp.asarray(p), jnp.asarray(t), slice_ids=jnp.asarray(ids))
    for cap in (None, 2, 10):
        a, b = ours.scrape_slices(cap), ref.scrape_slices(cap)
        assert a == b
    with pytest.raises(ValueError, match="max_labels"):
        ours.scrape_slices(0)
    for raw, want, warns in (("2", 2, 0), ("zero", 8, 1), ("-3", 8, 1)):
        monkeypatch.setenv("METRICS_TPU_SLICES_MAX_LABELS", raw)
        for mod in (tsl, jsl):
            mod.reset_sliced_state()
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                assert mod.slices_max_labels() == mod.slices_max_labels() == want
            assert sum("malformed" in str(w.message) for w in rec) == warns
        assert ours.scrape_slices() == ref.scrape_slices()
        assert len(ours.scrape_slices()["top"]) == min(want, K)
    tsl.reset_sliced_state()
    jsl.reset_sliced_state()


def test_windowed_over_sliced_matches_jax():
    ours = mtt.WindowedMetric(mtt.SlicedMetric(mtt.Accuracy(num_classes=C, device="cpu"), num_slices=K), window=24, buckets=3)
    ref = mt.WindowedMetric(jsl.SlicedMetric(mt.Accuracy(num_classes=C), num_slices=K), window=24, buckets=3)
    for i in range(5):
        p, t, ids = _rows(8, seed=10 + i)
        ours.update(torch.from_numpy(p), torch.from_numpy(t), slice_ids=torch.from_numpy(ids))
        ref.update(jnp.asarray(p), jnp.asarray(t), slice_ids=jnp.asarray(ids))
        assert_states_close(ours.metric_state, dict(ref.metric_state))
    out, want = ours.compute(), ref.compute()
    _close_values(out.per_slice, want.per_slice)
    _close_values(out.global_value, want.global_value)


def test_refusals_match_jax():
    cases = [
        (lambda pkg, **kw: pkg.QuantileSketch(**kw), "compaction"),
        (lambda pkg, **kw: pkg.AUROC(**kw), "cat/list"),
        (lambda pkg, **kw: pkg.AUROC(capacity=8, **kw), "cat/list"),
        (lambda pkg, **kw: pkg.WindowedMetric(pkg.SumMetric(**kw), window=4, buckets=2, **kw), "no per-row delta"),
    ]
    for factory, match in cases:
        with pytest.raises(ValueError, match=match):
            mtt.SlicedMetric(factory(mtt, device="cpu"), num_slices=K)
        with pytest.raises(ValueError, match=match):
            jsl.SlicedMetric(factory(mt), num_slices=K)
    for bad in (0, 2.0, -1):
        with pytest.raises(ValueError, match="num_slices"):
            mtt.SlicedMetric(mtt.SumMetric(device="cpu"), num_slices=bad)
        with pytest.raises(ValueError, match="num_slices"):
            jsl.SlicedMetric(mt.SumMetric(), num_slices=bad)
    with pytest.raises(MetricsTPUUserError, match="slice_ids"):
        mtt.SlicedMetric(mtt.SumMetric(device="cpu"), num_slices=K).update(torch.ones(3))
    with pytest.raises(JaxUserError, match="slice_ids"):
        jsl.SlicedMetric(mt.SumMetric(), num_slices=K).update(jnp.ones(3))


# the kernel-backed members: the Binned metrics reach K1, the confusion
# family K2 (through ``_bincount``); name: (factory(pkg, **kw), kernel)
KERNEL_BACKED = {
    "binned_pr_curve": (lambda pkg, **kw: pkg.BinnedPrecisionRecallCurve(num_classes=C, thresholds=5, **kw), "k1"),
    "binned_ap": (lambda pkg, **kw: pkg.BinnedAveragePrecision(num_classes=C, thresholds=5, **kw), "k1"),
    "binned_recall_at_precision": (
        lambda pkg, **kw: pkg.BinnedRecallAtFixedPrecision(num_classes=C, min_precision=0.3, thresholds=5, **kw), "k1"),
    "confusion_matrix": (lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=C, **kw), "k2"),
    "cohen_kappa": (lambda pkg, **kw: pkg.CohenKappa(num_classes=C, **kw), "k2"),
    "matthews": (lambda pkg, **kw: pkg.MatthewsCorrCoef(num_classes=C, **kw), "k2"),
    "jaccard": (lambda pkg, **kw: pkg.JaccardIndex(num_classes=C, **kw), "k2"),
}


@pytest.mark.parametrize("name", list(KERNEL_BACKED))
def test_kernel_backed_member_sliced_through_the_lane_route_matches_jax(name, monkeypatch):
    """A member whose update launches a kernel slices on every device: its
    per-row deltas reach the kernel's lane route (``ops/_build.py::
    lane_route``), one lane-batched call per update (on the card the
    kernel's batched form, here its plain version with the lane axis written
    out), and the rings equal the JAX package's bit for bit (integer counts,
    float32 counts of 0/1 rows), the per-slice values within ``atol``."""
    factory, kernel = KERNEL_BACKED[name]
    module, plain = (binned_counters, "binned_counter_update_lanes_plain") if kernel == "k1" else (histogram, "histogram_lanes_plain")
    inner = getattr(module, plain)
    calls = []
    monkeypatch.setattr(module, plain, lambda *a: calls.append(a[0].shape[0]) or inner(*a))
    ours = mtt.SlicedMetric(factory(mtt, device="cpu"), num_slices=K)
    ref = jsl.SlicedMetric(factory(mt), num_slices=K)
    sizes = (12, 7)
    for i, n in enumerate(sizes):
        p, t, ids = _rows(n, seed=31 + i)
        valid = (np.arange(n) % 4 != 1) if i == 1 else None
        ours.update(torch.from_numpy(p), torch.from_numpy(t), slice_ids=torch.from_numpy(ids),
                    valid=None if valid is None else torch.from_numpy(valid))
        ref.update(jnp.asarray(p), jnp.asarray(t), slice_ids=jnp.asarray(ids), valid=None if valid is None else jnp.asarray(valid))
    assert calls == list(sizes)  # one call per update, its lanes the update's rows
    assert_states_close(ours.metric_state, dict(ref.metric_state))
    _close_values(ours.compute().per_slice, ref.compute().per_slice)


def test_sliced_confusion_matrix_on_the_cpu_matches_jax():
    ours = mtt.SlicedMetric(mtt.ConfusionMatrix(num_classes=C, device="cpu"), num_slices=K)
    ref = jsl.SlicedMetric(mt.ConfusionMatrix(num_classes=C), num_slices=K)
    p, t, ids = _rows(21, seed=30)
    ours.update(torch.from_numpy(p), torch.from_numpy(t), slice_ids=torch.from_numpy(ids))
    ref.update(jnp.asarray(p), jnp.asarray(t), slice_ids=jnp.asarray(ids))
    assert_states_close(ours.metric_state, dict(ref.metric_state))
    _close_values(ours.compute().per_slice, ref.compute().per_slice)


# ----------------------------------------------------------------------
# the pure layer
# ----------------------------------------------------------------------


def _pure_twins(metric_factory, **kw):
    return mtt.sliced_functionalize(metric_factory(mtt, device="cpu"), K, **kw), mt.sliced_functionalize(metric_factory(mt), K)


def _fold(tdef, jdef, batches, kind="pt"):
    ts, js = tdef.init(), jdef.init()
    update = jax.jit(jdef.update)
    for p, t, ids in batches:
        ts = tdef.update(ts, *_args(kind, p, t, mtt), slice_ids=torch.from_numpy(ids))
        js = update(js, *_args(kind, p, t, mt), slice_ids=jnp.asarray(ids))
    return ts, js


def test_sliced_functionalize_metric_form_matches_jax():
    factory = CHILDREN["acc_drop"][0]
    tdef, jdef = _pure_twins(factory)
    batches = [_rows(n, seed=20 + i, nan=True) for i, n in enumerate((11, 16))]
    ts, js = _fold(tdef, jdef, batches)
    assert_states_close(ts, js)
    out, want = tdef.compute(ts), jdef.compute(js)
    _close_values(out.per_slice, want.per_slice)
    _close_values(out.global_value, want.global_value)
    # the fault counts live in the sl___faults ring: MetricDef.faults folds it
    np.testing.assert_array_equal(tdef.faults(ts).numpy(), np.asarray(jdef.faults(js)).astype(np.int64))
    assert int(tdef.faults(ts).sum()) > 0
    assert int(tdef.dropped(ts)) == int(jdef.dropped(js)) == 0
    # an explicit SlicedMetric passes through
    sdef = mtt.sliced_functionalize(mtt.SlicedMetric(factory(mtt, device="cpu"), num_slices=K), num_slices=99)
    assert_states_close(sdef.init(), tdef.init())


def test_sliced_functionalize_collection_form_matches_jax():
    def coll(pkg, **kw):
        return pkg.MetricCollection({
            "acc": pkg.Accuracy(num_classes=C, on_invalid="drop", **kw),
            "rec": pkg.Recall(num_classes=C, average="macro", **kw),
        })

    tdef, jdef = _pure_twins(coll)
    ts, js = _fold(tdef, jdef, [_rows(n, seed=40 + i) for i, n in enumerate((10, 7))])
    assert_states_close(ts, js)
    out, want = tdef.compute(ts), jdef.compute(js)
    assert set(out) == set(want) == {"acc", "rec"}
    for k in out:
        assert isinstance(out[k], tsl.SlicedValue)
        _close_values(out[k].per_slice, want[k].per_slice)
    np.testing.assert_array_equal(tdef.faults(ts).numpy(), np.asarray(jdef.faults(js)).astype(np.int64))
    with pytest.raises(ValueError, match="collection"):
        mtt.sliced_functionalize(coll(mtt, device="cpu"), K, shard_slices=object())
    # the slice shard is the data group: it is named once, by `shard_slices`
    with pytest.raises(ValueError, match="shard_slices"):
        mtt.sliced_functionalize(mtt.Accuracy(num_classes=C, device="cpu"), K, group=object(), shard_slices=object())


def test_faults_in_state_reads_the_ring_as_jax_does():
    ring = np.arange(7 * (K + 2), dtype=np.uint32).reshape(K + 2, 7)
    ours = _faults_in_state({"sl___faults": torch.from_numpy(ring.astype(np.int64))}, torch.device("cpu"))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_faults_in_state({"sl___faults": jnp.asarray(ring)})))
    # counters of the metric's own win over the ring, as in JAX
    own = mtt.FaultCounters(torch.ones(7, dtype=torch.int64))
    assert _faults_in_state({"_faults": own, "sl___faults": torch.zeros(K + 2, 7)}, torch.device("cpu")).tolist() == [1] * 7
    assert _faults_in_state({}, torch.device("cpu")).tolist() == [0] * 7


def test_sliced_states_cross_packages_both_ways():
    factory = CHILDREN["acc_drop"][0]
    # the stateful metric: a JAX state (the uint32 fault ring among it) into the port
    ours = mtt.SlicedMetric(factory(mtt, device="cpu"), num_slices=K)
    ref = jsl.SlicedMetric(factory(mt), num_slices=K)
    b1, b2 = _rows(12, seed=50, nan=True), _rows(9, seed=51, nan=True)
    ref.update(*_args("pt", b1[0], b1[1], mt), slice_ids=jnp.asarray(b1[2]))
    assert np.asarray(ref.metric_state["sl___faults"]).dtype == np.uint32
    load_jax_state(ours, dict(ref.metric_state))
    for m, pkg in ((ours, mtt), (ref, mt)):
        ids = torch.from_numpy(b2[2]) if pkg is mtt else jnp.asarray(b2[2])
        m.update(*_args("pt", b2[0], b2[1], pkg), slice_ids=ids)
    assert_states_close(ours.metric_state, dict(ref.metric_state))
    # the pure state, both ways
    tdef, jdef = _pure_twins(factory)
    ts, js = _fold(tdef, jdef, [b1])
    carried = load_jax_pure_state(tdef.init(), js)
    assert_states_close(carried, js)
    back = to_jax_pure_state(ts, jdef.init())
    nxt_t = tdef.update(carried, *_args("pt", b2[0], b2[1], mtt), slice_ids=torch.from_numpy(b2[2]))
    nxt_j = jax.jit(jdef.update)(back, *_args("pt", b2[0], b2[1], mt), slice_ids=jnp.asarray(b2[2]))
    assert_states_close(nxt_t, nxt_j)


# ----------------------------------------------------------------------
# sharded slices over four ranks
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    n = 4
    store = tmp_path_factory.mktemp("sliced4") / "store"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=R.rank_main, args=(r, n, str(store), queue)) for r in range(n)]
    for proc in procs:
        proc.start()
    try:
        results = dict(queue.get(timeout=240) for _ in procs)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    for r, res in sorted(results.items()):
        if "error" in res:
            pytest.fail(f"rank {r} of {n} failed:\n{res['error']}")
    assert [proc.exitcode for proc in procs] == [0] * n
    return n, [results[r] for r in range(n)]


def _jax_sharded(name, n):
    metric, args = R.metrics(mt)[name]
    sdef = mt.sliced_functionalize(metric, R.K, shard_slices="data", shard_count=n)
    update = jax.jit(sdef.update)
    states = []
    for p, t, ids in R.shards(n):
        states.append(update(sdef.init(), *(jnp.asarray(a) for a in args(p, t)), slice_ids=jnp.asarray(ids)))
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    out = jax.vmap(sdef.compute, axis_name="data")(stacked)
    faults = jax.vmap(sdef.faults, axis_name="data")(stacked)
    return out, faults


@pytest.mark.parametrize("name", ["acc", "max"])
def test_four_rank_sharded_slices_match_jax_under_vmap(world4, name):
    n, results = world4
    want, want_faults = _jax_sharded(name, n)
    for r, res in enumerate(results):
        assert res["jax_loaded"] == []
        got = res[name]["value"]
        for key in ("per_slice", "slice_rows", "slice_offset", "global_value", "quarantined_rows"):
            np.testing.assert_allclose(
                np.asarray(got[key], np.float64), np.asarray(jax.tree_util.tree_map(lambda x: x[r], want[key]), np.float64),
                rtol=0, atol=ATOL, err_msg=f"rank {r} {key}",
            )
        np.testing.assert_array_equal(res[name]["faults"], np.asarray(want_faults[r]).astype(np.int64))
        calls = [c[:2] + ((c[2].split(".")[-1],) if len(c) > 2 else ()) for c in res[name]["calls"]]
        if name == "acc":
            # JAX: one psum of the rollup, one psum_scatter of the rows and
            # one of each sum ring (tp, fp, tn, fn, the fault ring). The
            # port: the same count, the rollup's integers in one int64 bucket
            assert calls == [("all_reduce", "int64", "SUM")] + [("reduce_scatter",)] * 6, calls
        else:
            # MaxMetric's aggregator keeps fault counters ("warn" by
            # default): JAX psums the rollup, psum_scatters the rows and the
            # fault ring, and pmaxes the max ring
            assert calls == [("all_reduce", "int64", "SUM")] + [("reduce_scatter",)] * 2 + [("all_reduce", "float32", "MAX")], calls
        assert [c[:2] for c in res[name]["faults_calls"]] == [("all_reduce", "int64")]
