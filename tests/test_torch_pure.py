"""The pure layer of the port (``metrics_tpu_torch/pure.py``) against the JAX
package's ``metrics_tpu/pure.py``, on the same seeded numpy inputs.

The JAX side runs its pure updates under ``jax.jit``, as its users do. Tolerances:
counts, rings, fault counters and sketch levels exact; float32 states and
values ``atol=1e-6`` plus ``rtol=1e-6`` (float32 sums taken in another
order). The bootstrap's per-replica values are held bit-equal, given the
indices the JAX package drew.

Also held here: the purity rule (no input leaf of ``update``, ``merge``,
``cycle`` or ``compute`` changes, bit for bit), the template metric left as
it was, the same refusals in both packages, the pure states carried across
the packages both ways (``interop.py``), and one four-rank Gloo world
against JAX's ``functionalize(coll, axis_name="data")`` under
``jax.vmap(..., axis_name="data")``, with its collectives counted.
"""
import multiprocessing as mp
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.parallel.sync import fused_sync as jax_fused_sync  # noqa: E402
from metrics_tpu_torch.interop import load_jax_pure_state, to_jax_pure_state  # noqa: E402
from tests.helpers import torch_pure_ranks as R  # noqa: E402
from tests.helpers.torch_twins import assert_bits_equal, assert_states_close, leaves, np_leaf  # noqa: E402

RTOL = ATOL = 1e-6
C = 5
BATCH = 24


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


class JaxBatchMean(mt.Metric):
    """A ``"mean"``-reduced state: the last batch's mean."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("avg", default=jnp.asarray(0.0), dist_reduce_fx="mean")

    def update(self, x):
        self.avg = jnp.mean(jnp.asarray(x, jnp.float32))

    def compute(self):
        return self.avg


class TorchBatchMean(mtt.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("avg", default=torch.tensor(0.0), dist_reduce_fx="mean")

    def update(self, x):
        self.avg = torch.mean(x.to(torch.float32))

    def compute(self):
        return self.avg


def _class_batch(seed, n=BATCH, faults=False):
    rng = np.random.default_rng(seed)
    p = rng.random((n, C)).astype(np.float32)
    t = rng.integers(0, C, n)
    if faults:
        p[1, 2] = np.nan
        t[4] = C
    return p, t


def _reg_batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    t = (rng.integers(1, 11, n) / 2).astype(np.float32)
    return np.clip(t + rng.normal(scale=0.8, size=n), 0.5, 5.0).astype(np.float32), t


def _values_batch(seed, n=BATCH):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    x[3] = np.nan
    return (x,)


def _sketch_batch(seed, n=200):
    return (np.random.default_rng(seed).lognormal(0, 1, n).astype(np.float32),)


# (name, factory(pkg, **kw), batch maker): one metric per kind of state
KINDS = {
    "sum": (lambda pkg, **kw: pkg.Accuracy(num_classes=C, **kw), _class_batch),
    "sum_float": (lambda pkg, **kw: pkg.MeanSquaredError(**kw), _reg_batch),
    "mean": (lambda pkg, **kw: (TorchBatchMean if pkg is mtt else JaxBatchMean)(**kw), lambda s: _reg_batch(s)[:1]),
    "max": (lambda pkg, **kw: pkg.MaxMetric(nan_strategy="ignore", **kw), _values_batch),
    "min": (lambda pkg, **kw: pkg.MinMetric(nan_strategy="ignore", **kw), _values_batch),
    "none": (lambda pkg, **kw: pkg.PearsonCorrCoef(**kw), _reg_batch),
    "ring": (lambda pkg, **kw: pkg.SpearmanCorrCoef(capacity=60, **kw), _reg_batch),  # overflows at the third batch
    "sketch": (lambda pkg, **kw: pkg.QuantileSketch(eps=0.05, **kw), _sketch_batch),
    "faults": (lambda pkg, **kw: pkg.Accuracy(num_classes=C, on_invalid="drop", **kw), lambda s: _class_batch(s, faults=True)),
}


def _pair(kind):
    factory, batch = KINDS[kind]
    return factory(mtt, device="cpu"), factory(mt), batch


def _t(batch):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]


def _j(batch):
    return [jnp.asarray(a) for a in batch]


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            _close(ours[k], ref[k], rtol, atol)
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _close(o, r, rtol, atol)
    else:
        np.testing.assert_allclose(np_leaf(ours), np.asarray(ref), rtol=rtol, atol=atol)


def _fold(tdef, jdef, batch, seeds, ts=None, js=None):
    """The same batches through both definitions, states compared after each."""
    ts = tdef.init() if ts is None else ts
    js = jdef.init() if js is None else js
    jupdate = jax.jit(jdef.update)
    for s in seeds:
        b = batch(s)
        ts = tdef.update(ts, *_t(b))
        js = jupdate(js, *_j(b))
        assert_states_close(ts, js, RTOL, ATOL)
    return ts, js


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_functionalize_matches_jax_per_state_kind(kind):
    ours, ref, batch = _pair(kind)
    tdef, jdef = mtt.functionalize(ours), mt.functionalize(ref)
    assert_states_close(tdef.init(), jdef.init())
    ts, js = _fold(tdef, jdef, batch, (0, 1, 2))
    _close(tdef.compute(ts), jdef.compute(js))
    # merge of two partial states, with the update counts for a mean state
    ta, ja = _fold(tdef, jdef, batch, (3,))
    tb, jb = _fold(tdef, jdef, batch, (4, 5))
    counts = {"count_a": 1, "count_b": 2}
    if kind == "none":  # stacked moments have no pure merge rule, in either package
        for d, a, b in ((tdef, ta, tb), (jdef, ja, jb)):
            with pytest.raises(ValueError, match="no pure merge rule"):
                d.merge(a, b, **counts)
    else:
        merged_t, merged_j = tdef.merge(ta, tb, **counts), jdef.merge(ja, jb, **counts)
        assert_states_close(merged_t, merged_j, RTOL, ATOL)
        _close(tdef.compute(merged_t), jdef.compute(merged_j))
    assert int(tdef.dropped(ts)) == int(jdef.dropped(js))
    np.testing.assert_array_equal(np_leaf(tdef.faults(ts)), np.asarray(jdef.faults(js)).astype(np.int64))
    if kind == "ring":
        assert int(tdef.dropped(ts)) == 3 * BATCH - 60
    if kind == "faults":
        assert int(tdef.faults(ts).sum()) > 0


def test_mean_state_merge_needs_counts_in_both():
    tdef, jdef = mtt.functionalize(TorchBatchMean(device="cpu")), mt.functionalize(JaxBatchMean())
    with pytest.raises(ValueError, match="count_a"):
        jdef.merge(jdef.init(), jdef.init())
    with pytest.raises(ValueError, match="count_a"):
        tdef.merge(tdef.init(), tdef.init())


def _collection(pkg, **kw):
    return R.class_collection(pkg, **kw)


def test_collection_and_wrapper_forms_match_jax():
    tdef, jdef = mtt.functionalize(_collection(mtt, device="cpu")), mt.functionalize(_collection(mt))
    batch = lambda s: _class_batch(s, faults=True)  # noqa: E731
    assert isinstance(tdef.init()["per_class"], list) and len(tdef.init()["per_class"]) == 2
    ts, js = _fold(tdef, jdef, batch, (0, 1, 2))
    _close(tdef.compute(ts), jdef.compute(js))
    ta, ja = _fold(tdef, jdef, batch, (3,))
    merged_t, merged_j = tdef.merge(ts, ta, count_a=3, count_b=1), jdef.merge(js, ja, count_a=3, count_b=1)
    assert_states_close(merged_t, merged_j, RTOL, ATOL)
    _close(tdef.compute(merged_t), jdef.compute(merged_j))
    np.testing.assert_array_equal(np_leaf(tdef.faults(ts)), np.asarray(jdef.faults(js)).astype(np.int64))
    assert int(tdef.dropped(ts)) == int(jdef.dropped(js)) == 0
    # the sum over the members: three under "drop", and BAP under "warn",
    # which counts the same faults but drops no row
    drop = mtt.functionalize(mtt.Accuracy(num_classes=C, on_invalid="drop", device="cpu"))
    warn = mtt.functionalize(mtt.Accuracy(num_classes=C, on_invalid="warn", device="cpu"))
    sd, sw = drop.init(), warn.init()
    for s in (0, 1, 2):
        sd, sw = drop.update(sd, *_t(batch(s))), warn.update(sw, *_t(batch(s)))
    assert np.array_equal(np_leaf(tdef.faults(ts)), 3 * np_leaf(drop.faults(sd)) + np_leaf(warn.faults(sw)))


def _two_outputs(seed):
    return tuple(np.stack([c, c[::-1]], 1) for c in _reg_batch(seed))


@pytest.mark.parametrize(
    ("factory", "batch"),
    [
        (lambda pkg, **kw: pkg.ClasswiseWrapper(pkg.Precision(num_classes=C, average=None, **kw), labels=list("abcde")), _class_batch),
        (lambda pkg, **kw: pkg.MultioutputWrapper(pkg.MeanAbsoluteError(**kw), num_outputs=2, remove_nans=False), _two_outputs),
        (lambda pkg, **kw: pkg.WindowedMetric(pkg.Accuracy(num_classes=C, **kw), window=32, buckets=4), _class_batch),
        (lambda pkg, **kw: pkg.DecayedMetric(pkg.MeanMetric(nan_strategy="ignore", **kw), halflife=16.0), _values_batch),
    ],
    ids=["classwise", "multioutput", "windowed", "decayed"],
)
def test_wrapper_alone_matches_jax(factory, batch):
    ours, ref = factory(mtt, device="cpu"), factory(mt)
    tdef, jdef = mtt.functionalize(ours), mt.functionalize(ref)
    assert isinstance(tdef.init(), list) and len(tdef.init()) == len(jdef.init())
    ts, js = _fold(tdef, jdef, batch, (0, 1, 2))
    _close(tdef.compute(ts), jdef.compute(js))
    if not isinstance(ours, (mtt.WindowedMetric, mtt.DecayedMetric)):  # no merge rule for a window's cursor
        assert_states_close(tdef.merge(ts, ts), jdef.merge(js, js), RTOL, ATOL)


@pytest.mark.parametrize(
    "factory",
    [
        lambda pkg, **kw: pkg.SpearmanCorrCoef(**kw),  # unbounded list states
        lambda pkg, **kw: pkg.MinMaxMetric(pkg.MeanSquaredError(**kw)),  # jittable flags off
        lambda pkg, **kw: pkg.BootStrapper(pkg.MeanSquaredError(**kw), num_bootstraps=3),
        lambda pkg, **kw: pkg.MeanSquaredError(on_invalid="drop", **kw),  # drop without a valid mask
        lambda pkg, **kw: pkg.BinnedAveragePrecision(num_classes=C, thresholds=4, on_invalid="drop", **kw),
        lambda pkg, **kw: pkg.MeanMetric(nan_strategy="error", **kw),
        lambda pkg, **kw: pkg.CatMetric(**kw),
        lambda pkg, **kw: pkg.MultioutputWrapper(pkg.MeanSquaredError(**kw), num_outputs=2),  # removes NaN rows
        lambda pkg, **kw: pkg.ClasswiseWrapper(pkg.SpearmanCorrCoef(**kw)),
        lambda pkg, **kw: pkg.MetricCollection({"r": pkg.SpearmanCorrCoef(**kw)}),
    ],
)
def test_refusals_match_jax(factory):
    with pytest.raises(ValueError):
        mt.functionalize(factory(mt))
    with pytest.raises(ValueError):
        mtt.functionalize(factory(mtt, device="cpu"))


def test_non_metric_refused_in_both():
    for pkg, kw in ((mt, {}), (mtt, {"device": "cpu"})):
        with pytest.raises(TypeError):
            pkg.functionalize(pkg.MetricTracker(pkg.MeanSquaredError(**kw)))
        with pytest.raises(ValueError):
            pkg.bootstrap_functionalize(pkg.MeanSquaredError(**kw), 1)
        with pytest.raises(ValueError):
            pkg.overlapped_functionalize(pkg.MeanSquaredError(**kw), sync_transport="int4")


def test_flags_as_declared():
    assert mtt.Metric.jittable_update and mtt.Metric.jittable_compute
    for w in (mtt.ClasswiseWrapper, mtt.MinMaxMetric, mtt.MultioutputWrapper, mtt.BootStrapper, mtt.CompositionalMetric):
        assert not w.jittable_update and not w.jittable_compute
    for strategy, on_invalid, want in (("error", "ignore", False), ("warn", "ignore", False), ("warn", None, True), ("ignore", "ignore", True), (0.0, "ignore", True)):
        kw = {} if on_invalid is None else {"on_invalid": on_invalid}
        ours = mtt.SumMetric(nan_strategy=strategy, device="cpu", **kw)
        ref = mt.SumMetric(nan_strategy=strategy, **kw)
        assert ours.jittable_update == ref.jittable_update == want, (strategy, on_invalid)


def _bits(state):
    return {k: np.ascontiguousarray(v).tobytes() for k, v in leaves(state).items()}


@pytest.mark.parametrize("what", ["collection", "ring", "sketch", "faults", "wrapper"])
def test_purity_rule(what):
    """No leaf of a state given to ``update``, ``merge``, ``cycle`` or
    ``compute`` changes, bit for bit, and the outputs share no storage with
    the inputs' leaves that the port would write in place."""
    if what == "collection":
        metric, batch = _collection(mtt, device="cpu"), (lambda s: _class_batch(s, faults=True))
    elif what == "wrapper":
        metric, batch = mtt.ClasswiseWrapper(mtt.Recall(num_classes=C, average=None, device="cpu")), _class_batch
    else:
        metric, batch = _pair(what)[0], _pair(what)[2]
    mdef, odef = mtt.functionalize(metric), mtt.overlapped_functionalize(metric)
    state = mdef.update(mdef.init(), *_t(batch(0)))
    before = _bits(state)
    after_update = mdef.update(state, *_t(batch(1)))
    assert _bits(state) == before
    merged = mdef.merge(state, after_update, count_a=1, count_b=2)
    assert _bits(state) == before
    mdef.compute(merged)
    mdef.faults(state)
    mdef.dropped(state)
    assert _bits(state) == before
    # updating the merge again leaves both of its sources as they were
    moved = _bits(after_update)
    mdef.update(merged, *_t(batch(2)))
    assert _bits(after_update) == moved and _bits(state) == before
    ostate = odef.update(odef.init(), *_t(batch(0)))
    obefore = _bits(ostate)
    cycled = odef.cycle(ostate)
    assert _bits(ostate) == obefore
    odef.update(cycled, *_t(batch(1)))
    odef.read(cycled)
    odef.read_fresh(cycled)
    assert _bits(ostate) == obefore


def test_template_is_left_as_it_was():
    m = mtt.Accuracy(num_classes=C, device="cpu")
    m.update(*_t(_class_batch(9)))
    value = m.compute()
    own = _bits(m.metric_state)
    mdef = mtt.functionalize(m)
    s = mdef.update(mdef.init(), *_t(_class_batch(8)))
    mdef.compute(s)
    assert _bits(m.metric_state) == own and m.update_count == 1 and m._computed is value
    w = mtt.ClasswiseWrapper(mtt.Recall(num_classes=C, average=None, device="cpu"))
    wdef = mtt.functionalize(w)
    wdef.compute(wdef.update(wdef.init(), *_t(_class_batch(8))))
    assert w.metric.update_count == 0 and not w.metric.update_called and w.metric._to_sync


def test_overlapped_matches_jax_and_reads():
    tdef = mtt.overlapped_functionalize(_collection(mtt, device="cpu"))
    jdef = mt.overlapped_functionalize(_collection(mt))
    batch = lambda s: _class_batch(s, faults=True)  # noqa: E731
    ts, js = _fold(tdef, jdef, batch, (0, 1))
    assert int(tdef.lag(ts)) == int(jdef.lag(js)) == 2
    ts, js = tdef.cycle(ts), jax.jit(jdef.cycle)(js)
    assert_states_close(ts, js, RTOL, ATOL)
    assert int(tdef.lag(ts)) == 0
    assert_bits_equal(tdef.read(ts), tdef.read_fresh(ts))
    _close(tdef.read(ts), jdef.read(js))
    ts, js = _fold(tdef, jdef, batch, (2,), ts, js)
    assert int(tdef.lag(ts)) == int(jdef.lag(js)) == 1
    # the read trails the live state by one batch; the fresh read does not
    _close(tdef.read(ts), jdef.read(js))
    _close(tdef.read_fresh(ts), jdef.read_fresh(js))
    np.testing.assert_array_equal(np_leaf(tdef.faults(ts)), np.asarray(jdef.faults(js)).astype(np.int64))


def _jax_indices(key, b, n):
    """The indices JAX's ``bootstrap_functionalize`` draws from ``key``."""
    return np.stack([np.asarray(jax.random.choice(k, n, shape=(n,), replace=True)) for k in jax.random.split(key, b)])


@pytest.mark.parametrize("kind", ["sum", "sum_float", "faults"])
def test_bootstrap_bit_equal_to_jax_on_its_indices(kind):
    ours, ref, batch = _pair(kind)
    b = 7
    tdef, jdef = mtt.bootstrap_functionalize(ours, b), mt.bootstrap_functionalize(ref, b)
    ts, js = tdef.init(), jdef.init()
    assert_states_close(ts, js)
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        data = batch(i)
        js = jax.jit(jdef.update)(js, key, *_j(data))
        ts = tdef.update.with_indices(ts, torch.from_numpy(_jax_indices(key, b, len(data[0]))), *_t(data))
        assert_states_close(ts, js, RTOL, ATOL)
    out_t, out_j = tdef.compute(ts), jdef.compute(js)
    if kind == "sum_float":
        _close(out_t, out_j)
    else:
        assert_bits_equal(out_t["raw"], np.asarray(out_j["raw"]))
        _close(out_t, out_j)
    assert_states_close(tdef.merge(ts, ts), jdef.merge(js, js), RTOL, ATOL)
    np.testing.assert_array_equal(np_leaf(tdef.faults(ts)), np.asarray(jdef.faults(js)).astype(np.int64))
    assert int(tdef.dropped(ts)) == int(jdef.dropped(js))


# bootstraps whose update reaches a kernel: name: (factory(pkg, **kw), batch
# maker, the kernel module and its lanes' plain version)
KERNEL_BOOTSTRAPS = {
    "binned_ap": (lambda pkg, **kw: pkg.BinnedAveragePrecision(num_classes=C, thresholds=6, **kw), _class_batch,
                  "binned_counters", "binned_counter_update_lanes_plain"),
    "confusion_matrix": (lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=C, **kw), _class_batch,
                         "histogram", "histogram_lanes_plain"),
    "quantile_sketch": (KINDS["sketch"][0], _sketch_batch, "compactor", "fold_cascade_lanes_plain"),
}


@pytest.mark.parametrize("name", list(KERNEL_BOOTSTRAPS))
def test_bootstrap_of_a_kernel_backed_metric_bit_equal_to_jax_on_its_indices(name, monkeypatch):
    """The replicas' vmapped update reaches the kernel's lane route (K1, K2
    or K3's cascade): one lane-batched call an update, the replicas as its
    lanes (on the card the kernel's batched form, here its plain version
    with the lane axis written out). The states are bit-equal to JAX's on
    the indices JAX drew; the per-replica values are bit-equal where they
    are counts or sketch items (the confusion matrix, the quantiles) and
    within ``atol`` where they are float32 arithmetic on the counts (the
    average precision); the mean and std within ``atol``."""
    import importlib

    factory, batch, kernel, plain = KERNEL_BOOTSTRAPS[name]
    module = importlib.import_module(f"metrics_tpu_torch.ops.{kernel}")
    inner = getattr(module, plain)
    lanes = []
    monkeypatch.setattr(module, plain, lambda *a: lanes.append(a[0].shape[0]) or inner(*a))
    b = 6
    tdef, jdef = mtt.bootstrap_functionalize(factory(mtt, device="cpu"), b), mt.bootstrap_functionalize(factory(mt), b)
    ts, js = tdef.init(), jdef.init()
    jupdate = jax.jit(jdef.update)
    for i in range(2):
        key = jax.random.PRNGKey(30 + i)
        data = batch(i)
        js = jupdate(js, key, *_j(data))
        ts = tdef.update.with_indices(ts, torch.from_numpy(_jax_indices(key, b, len(data[0]))), *_t(data))
        assert_states_close(ts, js)
    assert lanes == [b, b]
    out_t, out_j = tdef.compute(ts), jdef.compute(js)
    if name != "binned_ap":
        assert_bits_equal(out_t["raw"], jax.tree_util.tree_map(np.asarray, out_j["raw"]))
    _close(out_t, out_j)


def test_bootstrap_generator_update_equals_separate_updates():
    """The vmapped update equals one ``functionalize`` update per replica on
    the same indices, bit for bit; the generator draws the indices."""
    b, n = 5, 30
    metric = mtt.Accuracy(num_classes=C, device="cpu")
    bdef, mdef = mtt.bootstrap_functionalize(metric, b), mtt.functionalize(metric)
    p, t = _t(_class_batch(3, n=n))
    gen = torch.Generator().manual_seed(4)
    idx = torch.randint(0, n, (b, n), generator=torch.Generator().manual_seed(4))
    state = bdef.update(bdef.init(), gen, p, t)
    for i in range(b):
        one = mdef.update(mdef.init(), p[idx[i]], t[idx[i]])
        assert_bits_equal({k: v[i] for k, v in state.items()}, one)
    with pytest.raises(ValueError, match="leading dim"):
        bdef.update(bdef.init(), gen, p, t[:-1])


def _roundtrip(tstate, jstate, template):
    """JAX -> port -> JAX, bit-equal each way."""
    ported = load_jax_pure_state(template, jstate)
    assert_states_close(ported, jstate)
    back = to_jax_pure_state(ported, jstate)
    assert_states_close(leaves(back), leaves(jstate))
    for k, v in leaves(back).items():
        assert v.dtype == leaves(jstate)[k].dtype, k
    assert_states_close(to_jax_pure_state(tstate, jstate), jstate, RTOL, ATOL)
    return ported, back


@pytest.mark.parametrize("layout", ["metric_def", "wrapper", "overlapped", "bootstrap", "collection"])
def test_pure_states_cross_packages_both_ways(layout):
    if layout == "metric_def":
        tdef, jdef = mtt.functionalize(mtt.SpearmanCorrCoef(capacity=40, on_invalid="drop", device="cpu")), mt.functionalize(mt.SpearmanCorrCoef(capacity=40, on_invalid="drop"))
        batch = _reg_batch
    elif layout == "wrapper":
        tdef = mtt.functionalize(mtt.ClasswiseWrapper(mtt.Recall(num_classes=C, average=None, on_invalid="drop", device="cpu")))
        jdef = mt.functionalize(mt.ClasswiseWrapper(mt.Recall(num_classes=C, average=None, on_invalid="drop")))
        batch = lambda s: _class_batch(s, faults=True)  # noqa: E731
    elif layout == "overlapped":
        tdef, jdef = mtt.overlapped_functionalize(_collection(mtt, device="cpu")), mt.overlapped_functionalize(_collection(mt))
        batch = lambda s: _class_batch(s, faults=True)  # noqa: E731
    elif layout == "collection":
        tdef, jdef = mtt.functionalize(R.reg_collection(mtt, device="cpu")), mt.functionalize(R.reg_collection(mt))
        batch = _reg_batch
    else:
        tdef = mtt.bootstrap_functionalize(mtt.Accuracy(num_classes=C, on_invalid="drop", device="cpu"), 4)
        jdef = mt.bootstrap_functionalize(mt.Accuracy(num_classes=C, on_invalid="drop"), 4)
        batch = None
    if batch is None:
        data = _class_batch(0, faults=True)
        js = jax.jit(jdef.update)(jdef.init(), jax.random.PRNGKey(0), *_j(data))
        ts = tdef.update.with_indices(tdef.init(), torch.from_numpy(_jax_indices(jax.random.PRNGKey(0), 4, BATCH)), *_t(data))
    else:
        ts, js = _fold(tdef, jdef, batch, (0, 1))
        if layout == "overlapped":
            ts, js = tdef.cycle(ts), jax.jit(jdef.cycle)(js)
    ported, back = _roundtrip(ts, js, tdef.init())
    # both packages go on from the carried state alike
    if batch is not None:
        nxt_t = tdef.update(ported, *_t(batch(5)))
        nxt_j = jax.jit(jdef.update)(back, *_j(batch(5)))
        assert_states_close(nxt_t, nxt_j, RTOL, ATOL)
        compute = tdef.read if layout == "overlapped" else tdef.compute
        jcompute = jdef.read if layout == "overlapped" else jdef.compute
        _close(compute(nxt_t), jcompute(nxt_j))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    n = 4
    store = tmp_path_factory.mktemp("pure4") / "store"
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


def _jax_world(factory, shards, compute="compute", **fns):
    """JAX's pure definition with ``axis_name="data"`` run under
    ``jax.vmap`` over the ranks' stacked states."""
    coll = factory(mt)  # one template: its updates infer the modes its compute reads
    jdef = mt.functionalize(coll, axis_name="data")
    local = mt.functionalize(coll)
    update = jax.jit(local.update)
    states = []
    for rows in shards:
        s = local.init()
        for batch in R.batches(rows):
            s = update(s, *_j(batch))
        states.append(s)
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    return jax.vmap(getattr(jdef, compute), axis_name="data")(stacked)


def _rank0(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[0], tree)


def _all_reduce_buckets(states):
    """The (dtype, SUM) buckets a sync of ``states`` makes: every sum-state
    leaf's dtype, the fault counters' int64."""
    return sorted({("all_reduce", str(v.dtype)) for v in leaves(states).values()})


def test_four_rank_pure_world_matches_jax_under_vmap(world4):
    n, results = world4
    want = _rank0(_jax_world(R.class_collection, R.class_shards(n)))
    want_faults = _rank0(_jax_world(R.class_collection, R.class_shards(n), compute="faults"))
    want_reg = _rank0(_jax_world(R.reg_collection, R.reg_shards(n)))
    fused = {k: v for k, v in results[0]["local_state"].items() if k != "per_class"}
    fused_buckets = _all_reduce_buckets(fused)
    wrapper_buckets = _all_reduce_buckets(results[0]["local_state"]["per_class"])
    for res in results:
        assert res["jax_loaded"] == []
        # one all_reduce per (reduction, dtype) bucket of the fused members,
        # then the wrapper's own, and no gather
        calls = [tuple(c[:2]) for c in res["class_calls"]]
        assert all(c[2].endswith("SUM") for c in res["class_calls"])
        assert sorted(calls[: len(fused_buckets)]) == fused_buckets
        assert sorted(calls[len(fused_buckets):]) == wrapper_buckets
        assert [tuple(c[:2]) for c in res["faults_calls"]] == [("all_reduce", "int64")]
        _close(res["class_values"], want)
        np.testing.assert_array_equal(res["faults"], np.asarray(want_faults).astype(np.int64))
        # the overlapped cycle is one fused sync of the whole tree; the read makes no collective
        cycle = sorted(tuple(c[:2]) for c in res["cycle_calls"])
        assert cycle == sorted(set(fused_buckets + wrapper_buckets))
        assert res["read_calls"] == [] and res["lag"] == 0
        assert_bits_equal(res["read"], res["read_fresh"])
        _close(res["read"], want)
        # Pearson's moments stacked and Spearman's rings gathered
        assert any(c[0] == "all_gather" for c in res["reg_calls"])
        _close(res["reg_values"], want_reg, rtol=1e-5, atol=1e-6)
    for res in results[1:]:
        assert_bits_equal(res["class_values"], results[0]["class_values"])
        assert_bits_equal(res["reg_values"], results[0]["reg_values"])


def _jax_bootstrap_world(name, b, n):
    """JAX's ``bootstrap_functionalize(metric, b, axis_name="data")`` under
    ``jax.vmap`` over the ranks, each replica updated on the ranks' numpy
    indices (as JAX's own update does on the indices it draws); and the
    number of ``psum`` its ``compute`` traces to."""
    metric, shards = R.boot_metrics(mt)[name]
    local = mt.functionalize(metric)
    jdef = mt.bootstrap_functionalize(metric, b, axis_name="data")
    resampled = jax.jit(jax.vmap(lambda st, i, *batch: local.update(st, *(a[i] for a in batch)),
                                 in_axes=(0, 0) + (None,) * len(shards(n)[0])))
    states = []
    for rank, rows in enumerate(shards(n)):
        s = mt.bootstrap_functionalize(metric, b).init()
        for j, batch in enumerate(R.batches(rows)):
            idx = jnp.asarray(R.boot_indices(rank, j, b, batch[0].shape[0]))
            s = resampled(s, idx, *_j(batch))
        states.append(s)
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    out = {fn: _rank0(jax.vmap(getattr(jdef, fn), axis_name="data")(stacked)) for fn in ("compute", "faults", "dropped")}
    if name in R.SKETCHES and b == R.BOOTSTRAPS[0]:  # the synced stacked state, as JAX's batched compute syncs it
        reds = dict(metric._reductions)
        sync = jax.vmap(jax.vmap(lambda st: jax_fused_sync([st], [reds], "data")[0]), axis_name="data")
        out["synced"] = _rank0(sync(stacked))
    jaxpr = str(jax.make_jaxpr(jdef.compute, axis_env=[("data", n)])(states[0]))
    return out, sum(jaxpr.count(c) for c in ("psum", "pmax", "pmin", "all_gather"))


# the bootstrap's metrics, one of each state kind JAX's batched sync takes
# (tests/helpers/torch_pure_ranks.py::boot_metrics)
BOOT_METRICS = ("acc", "pearson", "spearman", "auroc", "quantile", "hll", "countmin", "callable")


def _assert_synced_sketches_equal(ours, ref):
    """A synced stacked sketch state of the port (``_numpy``'s fields) and of
    JAX, field by field, bit for bit (integers by value: CountMin is int64
    here and uint32 in JAX, D4)."""
    assert sorted(ours) == sorted(ref)
    for name, fields in ours.items():
        for f, got in fields.items():
            got, want = np.asarray(got), np.asarray(getattr(ref[name], f))
            if want.dtype.kind in "iu":
                got, want = got.astype(np.int64), want.astype(np.int64)
            assert_bits_equal(got, want)


@pytest.mark.parametrize("name", BOOT_METRICS)
def test_four_rank_bootstrap_syncs_the_stack_once(world4, name):
    """``bootstrap_functionalize(..., group=WORLD)`` equals JAX's under
    ``jax.vmap(axis_name="data")`` for every state kind (each replica's
    ring the union of its own rows, its sketch the fold of its own), and
    neither package's collectives grow with the number of replicas: the
    port's are no more than one replica's ``functionalize`` sync."""
    n, results = world4
    psums = {}
    for b in R.BOOTSTRAPS:
        key = f"boot_{name}_{b}"
        want, psums[b] = _jax_bootstrap_world(name, b, n)
        for res in results:
            if "synced" in want:  # at the first replica count (eager JAX merges are slow)
                _assert_synced_sketches_equal(res[f"{key}_synced"], want["synced"])
            if name in ("quantile", "countmin"):  # quantiles exact while the weights are (D5), counts exact
                assert_bits_equal(np.asarray(res[f"{key}_compute"]["raw"]).astype(np.asarray(want["compute"]["raw"]).dtype),
                                  np.asarray(want["compute"]["raw"]))
            _close(res[f"{key}_compute"]["raw"], want["compute"]["raw"])
            # the mean and std over the replicas: float32 sums in another
            # order, each off by an ulp of the values it sums
            scale = max(1.0, float(np.abs(np.asarray(want["compute"]["raw"], np.float64)).max()))
            for stat in ("mean", "std"):
                _close(res[f"{key}_compute"][stat], want["compute"][stat], atol=ATOL * scale)
            np.testing.assert_array_equal(res[f"{key}_faults"], np.asarray(want["faults"]).astype(np.int64))
            assert int(res[f"{key}_dropped"]) == int(want["dropped"])
            assert (int(want["dropped"]) > 0) == (name == "spearman")  # only its ring overflows
            # every replica's counts in one all_reduce
            assert [tuple(c[:2]) for c in res[f"{key}_faults_calls"]] == [("all_reduce", "int64")]
            assert [tuple(c[:2]) for c in res[f"{key}_dropped_calls"]] == [("all_reduce", "int32")]
        if name == "acc":
            # one all_reduce per (reduction, dtype) bucket of the stacked state, and no gather
            calls = sorted(tuple(c[:2]) for c in results[0][f"{key}_compute_calls"])
            assert calls == _all_reduce_buckets(results[0][f"{key}_local_state"])
    a, b = R.BOOTSTRAPS
    for res in results:
        calls = res[f"boot_{name}_{a}_compute_calls"]
        assert calls == res[f"boot_{name}_{b}_compute_calls"]
        assert 0 < len(calls) <= len(res[f"single_{name}_compute_calls"])
    assert psums[a] == psums[b] > 0
