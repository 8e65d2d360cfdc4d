"""The five wrappers of the port (``metrics_tpu_torch/wrappers/``) against
their JAX twins, on the same seeded numpy inputs, with the forward
protocol's recursion into child metrics (a wrapper's batch value comes from
its children's fresh states, and their accumulated states are kept).

Tolerances: counts exact; float32 values and states ``atol=1e-6`` plus
``rtol=1e-6`` (sums in another order). ``BootStrapper`` draws its indices
from a ``torch.Generator`` where the JAX package draws from numpy's global
generator, so the parity test feeds the port the indices the JAX package
drew (``_update_with_indices``).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.wrappers.bootstrapping import _bootstrap_sampler as jax_sampler  # noqa: E402
from tests.helpers.torch_twins import assert_states_close, np_leaf  # noqa: E402

RTOL = ATOL = 1e-6
C = 4
BATCH = 20


def _cls_data(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, C)).astype(np.float32)
    return (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32), rng.integers(0, C, n)


def _reg_data(seed, n=BATCH, outputs=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if outputs is None else (n, outputs)
    t = rng.normal(size=shape).astype(np.float32)
    return (t + rng.normal(scale=0.5, size=shape)).astype(np.float32), t


def _close(ours, ref):
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            _close(ours[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _close(o, r)
    else:
        np.testing.assert_allclose(np_leaf(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _tree_states(metric):
    """Every state of a wrapper's tree, by child path (the snapshot's)."""
    snap = metric.snapshot_state()

    def walk(s):
        out = {"states": s["states"]}
        for name, child in s.get("children", {}).items():
            out[name] = walk(child)
        return out

    return walk(snap)


def _step(ours, ref, op, args):
    t_args = [torch.from_numpy(a) for a in args]
    j_args = [jnp.asarray(a) for a in args]
    if op == "update":
        ours.update(*t_args)
        ref.update(*j_args)
    else:
        _close(ours(*t_args), ref(*j_args))
    assert_states_close(_tree_states(ours), _tree_states(ref), RTOL, ATOL)


@pytest.mark.parametrize("labels", [None, ["a", "b", "c", "d"]])
def test_classwise_matches_jax(labels):
    ours = mtt.ClasswiseWrapper(mtt.Recall(num_classes=C, average=None, device="cpu"), labels=labels)
    ref = mt.ClasswiseWrapper(mt.Recall(num_classes=C, average=None), labels=labels)
    for i, op in enumerate(("update", "forward", "forward", "update")):
        _step(ours, ref, op, _cls_data(i))
    _close(ours.compute(), ref.compute())
    ours.reset()
    assert int(ours.metric.metric_state["tp"].sum()) == 0


def test_forward_recursion_keeps_the_children_accumulated():
    """Through ``forward`` a wrapper's child counts each batch once: equal to
    a twin driven by ``update`` alone."""
    fwd = mtt.ClasswiseWrapper(mtt.Accuracy(num_classes=C, average=None, device="cpu"))
    upd = mtt.ClasswiseWrapper(mtt.Accuracy(num_classes=C, average=None, device="cpu"))
    for i in range(3):
        p, t = (torch.from_numpy(a) for a in _cls_data(10 + i))
        batch = fwd(p, t)
        upd.update(p, t)
        alone = mtt.ClasswiseWrapper(mtt.Accuracy(num_classes=C, average=None, device="cpu"))
        alone.update(p, t)
        _close(batch, {k: np_leaf(v) for k, v in alone.compute().items()})
    assert_states_close(_tree_states(fwd), _tree_states(upd))
    assert fwd.metric.update_count == upd.metric.update_count == 3


@pytest.mark.parametrize("full_state", [True, False])
def test_minmax_matches_jax(full_state):
    base = (lambda pkg, **kw: pkg.PearsonCorrCoef(**kw)) if full_state else (lambda pkg, **kw: pkg.MeanSquaredError(**kw))
    ours, ref = mtt.MinMaxMetric(base(mtt, device="cpu")), mt.MinMaxMetric(base(mt))
    for i, op in enumerate(("forward", "update", "forward", "update")):
        _step(ours, ref, op, _reg_data(i))
        _close(ours.compute(), ref.compute())
    ours.reset()
    ref.reset()
    assert float(ours.min_val) == float("inf") and float(ours.max_val) == float("-inf")
    _step(ours, ref, "update", _reg_data(9))
    _close(ours.compute(), ref.compute())


def test_minmax_refuses_a_non_scalar_value():
    m = mtt.MinMaxMetric(mtt.MeanSquaredError(num_outputs=2, device="cpu"))
    m.update(torch.ones(3, 2), torch.zeros(3, 2))
    with pytest.raises(RuntimeError, match="scalar"):
        m.compute()


@pytest.mark.parametrize("remove_nans", [True, False])
def test_multioutput_matches_jax(remove_nans):
    ours = mtt.MultioutputWrapper(mtt.MeanAbsoluteError(device="cpu"), num_outputs=3, remove_nans=remove_nans)
    ref = mt.MultioutputWrapper(mt.MeanAbsoluteError(), num_outputs=3, remove_nans=remove_nans)
    assert ours._wrapper_trace_safe == (not remove_nans)
    for i, op in enumerate(("update", "forward", "update")):
        p, t = _reg_data(20 + i, outputs=3)
        if remove_nans:
            p[i, 1] = np.nan
            t[i + 3, 2] = np.nan
        _step(ours, ref, op, (p, t))
    _close(ours.compute(), ref.compute())


def test_multioutput_of_r2_matches_jax():
    ours = mtt.MultioutputWrapper(mtt.R2Score(device="cpu"), num_outputs=2)
    ref = mt.MultioutputWrapper(mt.R2Score(), num_outputs=2)
    for i in range(2):
        _step(ours, ref, "update", _reg_data(30 + i, outputs=2))
    _close(ours.compute(), ref.compute())


def _tracked(pkg, maximize, collection, **kw):
    if collection:
        metric = pkg.MetricCollection({"mse": pkg.MeanSquaredError(**kw), "r2": pkg.R2Score(**kw)})
    else:
        metric = pkg.MeanSquaredError(**kw)
    return pkg.MetricTracker(metric, maximize=maximize)


@pytest.mark.parametrize(("collection", "maximize"), [(False, False), (False, True), (True, [False, True]), (True, False)])
def test_tracker_best_metric_matches_jax(collection, maximize):
    ours = _tracked(mtt, maximize, collection, device="cpu")
    ref = _tracked(mt, maximize, collection)
    for epoch, noise in enumerate((1.0, 0.3, 0.6)):
        ours.increment()
        ref.increment()
        for b in range(2):
            p, t = _reg_data(40 + 2 * epoch + b)
            p = t + (p - t) * noise
            if b == 0:
                _close(ours(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)))
            else:
                ours.update(torch.from_numpy(p), torch.from_numpy(t))
                ref.update(jnp.asarray(p), jnp.asarray(t))
    assert ours.n_steps == ref.n_steps == 3
    _close(ours.compute_all(), ref.compute_all())
    step_o, best_o = ours.best_metric(return_step=True)
    step_r, best_r = ref.best_metric(return_step=True)
    assert step_o == step_r
    _close(best_o, best_r)


def test_tracker_refusals_and_non_scalar_best():
    with pytest.raises(TypeError):
        mtt.MetricTracker([1, 2])
    t = mtt.MetricTracker(mtt.MeanSquaredError(num_outputs=2, device="cpu"))
    with pytest.raises(ValueError, match="increment"):
        t.update(torch.ones(2, 2), torch.ones(2, 2))
    t.increment()
    t.update(torch.ones(3, 2), torch.zeros(3, 2))
    with pytest.warns(UserWarning, match="best"):
        assert t.best_metric() is None


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("extras", [dict(), dict(raw=True, quantile=0.9)])
def test_bootstrapper_matches_jax_on_jax_indices(strategy, extras):
    b = 5
    ours = mtt.BootStrapper(mtt.MeanSquaredError(device="cpu"), num_bootstraps=b, sampling_strategy=strategy, **extras)
    ref = mt.BootStrapper(mt.MeanSquaredError(), num_bootstraps=b, sampling_strategy=strategy, **extras)
    for i in range(3):
        p, t = _reg_data(50 + i)
        np.random.seed(100 + i)
        indices = [jax_sampler(len(p), strategy) for _ in range(b)]
        np.random.seed(100 + i)
        ref.update(jnp.asarray(p), jnp.asarray(t))
        ours._update_with_indices(indices, torch.from_numpy(p), torch.from_numpy(t))
        assert_states_close(_tree_states(ours), _tree_states(ref), RTOL, ATOL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the body method leaves the wrapper's update flag alone
        _close(ours.compute(), ref.compute())


def test_bootstrapper_draws_from_its_generator():
    """Two copies with equally seeded generators draw the same resamples:
    one through ``forward`` (the protocol's recursion merges each copy's
    batch state into its accumulated one), one through ``update``."""
    def make():
        return mtt.BootStrapper(mtt.Accuracy(num_classes=C, device="cpu"), num_bootstraps=4, generator=torch.Generator().manual_seed(7))

    fwd, upd = make(), make()
    for i in range(3):
        p, t = (torch.from_numpy(a) for a in _cls_data(60 + i))
        fwd(p, t)
        upd.update(p, t)
    assert_states_close(_tree_states(fwd), _tree_states(upd))
    out = upd.compute()
    assert sorted(out) == ["mean", "std"] and out["std"] > 0
    with pytest.raises(ValueError, match="sampling"):
        mtt.BootStrapper(mtt.Accuracy(device="cpu"), sampling_strategy="x")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wrapper_snapshot_crosses_packages(direction):
    """A wrapper's snapshot (its children's states and counts) loads across
    the two packages both ways, and both go on updating alike."""
    def pair():
        return (
            mtt.ClasswiseWrapper(mtt.Precision(num_classes=C, average=None, device="cpu")),
            mt.ClasswiseWrapper(mt.Precision(num_classes=C, average=None)),
        )

    src_o, src_r = pair()
    for i in range(2):
        p, t = _cls_data(70 + i)
        src_o.update(torch.from_numpy(p), torch.from_numpy(t))
        src_r.update(jnp.asarray(p), jnp.asarray(t))
    dst_o, dst_r = pair()
    if direction == "jax_to_port":
        dst_o.load_snapshot_state(src_r.snapshot_state())
        dst_r.load_snapshot_state(src_r.snapshot_state())
    else:
        dst_r.load_snapshot_state(src_o.snapshot_state())
        dst_o.load_snapshot_state(src_o.snapshot_state())
    assert dst_o.metric.update_count == dst_r.metric.update_count == 2
    p, t = _cls_data(79)
    dst_o.update(torch.from_numpy(p), torch.from_numpy(t))
    dst_r.update(jnp.asarray(p), jnp.asarray(t))
    assert_states_close(_tree_states(dst_o), _tree_states(dst_r))
    _close(dst_o.compute(), dst_r.compute())


def test_wrappers_take_the_wrapped_metrics_device():
    base = mtt.MeanSquaredError(device="cpu")
    for w in (mtt.ClasswiseWrapper(mtt.Recall(num_classes=C, average=None, device="cpu")), mtt.MinMaxMetric(base),
              mtt.MultioutputWrapper(base, 2), mtt.BootStrapper(base, 2)):
        assert w.device.type == "cpu"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError):
            mtt.ClasswiseWrapper(mtt.Recall(num_classes=C, device="cpu"), labels="abc")
