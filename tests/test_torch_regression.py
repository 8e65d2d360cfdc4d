"""The regression metrics of the port (``metrics_tpu_torch/regression/`` and
``functional/regression/``) against their JAX twins, on the same seeded
numpy inputs.

Tolerances: counts, ring masks and ranks exact; float32 states and values
``atol=1e-6`` plus ``rtol=1e-6`` (the two packages sum float32 terms in
another order: a batch's sum, a norm, a mean). Every state must have the
JAX package's dtype (float32 sums, int32 counts).
"""
import contextlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.functional as jF  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.functional.regression as tF  # noqa: E402
from metrics_tpu.functional.regression.spearman import _rank_data as jax_rank_data  # noqa: E402
from metrics_tpu.regression.pearson import _final_aggregation as jax_final_aggregation  # noqa: E402
from metrics_tpu_torch.functional.regression.spearman import _rank_data as torch_rank_data  # noqa: E402
from metrics_tpu_torch.regression.pearson import _final_aggregation as torch_final_aggregation  # noqa: E402
from tests.helpers.torch_twins import assert_states_close, np_leaf  # noqa: E402

RTOL = ATOL = 1e-6
BATCH = 24
OUTPUTS = 3


def _data(kind, seed, n=BATCH):
    rng = np.random.default_rng(seed)
    if kind == "1d":
        t = rng.normal(size=n).astype(np.float32)
        return (t + rng.normal(scale=0.5, size=n)).astype(np.float32), t
    if kind == "positive":
        t = rng.uniform(0.5, 5.0, n).astype(np.float32)
        return np.clip(t + rng.normal(scale=0.8, size=n), 0.5, 5.0).astype(np.float32), t
    if kind == "nonneg":  # Poisson-like targets with zeros, positive predictions
        return rng.uniform(0.1, 4.0, n).astype(np.float32), rng.poisson(1.5, n).astype(np.float32)
    if kind == "2d":
        t = rng.normal(size=(n, OUTPUTS)).astype(np.float32)
        return (t + rng.normal(scale=0.5, size=(n, OUTPUTS))).astype(np.float32), t
    if kind == "rows":  # embeddings for the cosine similarity
        return rng.normal(size=(n, 5)).astype(np.float32), rng.normal(size=(n, 5)).astype(np.float32)
    if kind == "ratings":  # a half-star grid: mostly ties
        t = (rng.integers(1, 11, n) / 2).astype(np.float32)
        return (np.round(np.clip(t + rng.normal(scale=0.8, size=n), 0.5, 5.0) * 2) / 2).astype(np.float32), t
    raise KeyError(kind)


@contextlib.contextmanager
def _quiet():
    """Silences the overflow warnings of the cases that overflow a ring."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _values_close(ours, ref, rtol=RTOL, atol=ATOL):
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            _values_close(ours[k], ref[k], rtol, atol)
        return
    if isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _values_close(o, r, rtol, atol)
        return
    np.testing.assert_allclose(np_leaf(ours), np.asarray(ref), rtol=rtol, atol=atol)


def run_twins(ours, ref, kind, ops=("update", "forward", "update"), rtol=RTOL, atol=ATOL):
    """The same batches through both (the last one shorter); states after
    each call, the batch values of ``forward`` and ``compute()``."""
    for i, op in enumerate(ops):
        preds, target = _data(kind, 100 + i, n=BATCH - 5 * (i == len(ops) - 1))
        if op == "update":
            ours.update(torch.from_numpy(preds), torch.from_numpy(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        else:
            _values_close(ours(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)), rtol, atol)
        assert_states_close(ours.metric_state, ref.metric_state, rtol, atol)
    _values_close(ours.compute(), ref.compute(), rtol, atol)


CASES = [
    ("MeanSquaredError", {}, "1d"),
    ("MeanSquaredError", {"squared": False}, "1d"),
    ("MeanSquaredError", {"num_outputs": OUTPUTS}, "2d"),
    ("MeanAbsoluteError", {}, "1d"),
    ("MeanSquaredLogError", {}, "positive"),
    ("MeanAbsolutePercentageError", {}, "1d"),
    ("SymmetricMeanAbsolutePercentageError", {}, "1d"),
    ("WeightedMeanAbsolutePercentageError", {}, "1d"),
    ("CosineSimilarity", {"reduction": "sum"}, "rows"),
    ("CosineSimilarity", {"reduction": "mean"}, "rows"),
    ("CosineSimilarity", {"reduction": "none"}, "rows"),
    ("CosineSimilarity", {"reduction": "sum", "capacity": 64}, "rows"),
    ("CosineSimilarity", {"reduction": "mean", "capacity": 64}, "rows"),
    ("CosineSimilarity", {"reduction": "none", "capacity": 64}, "rows"),
    ("CosineSimilarity", {"reduction": "none", "capacity": 40}, "rows"),  # overflows: rows dropped and counted
    ("ExplainedVariance", {}, "1d"),
    ("ExplainedVariance", {"multioutput": "raw_values"}, "2d"),
    ("ExplainedVariance", {"multioutput": "variance_weighted"}, "2d"),
    ("PearsonCorrCoef", {}, "1d"),
    ("PearsonCorrCoef", {}, "ratings"),
    ("R2Score", {}, "1d"),
    ("R2Score", {"num_outputs": OUTPUTS, "multioutput": "raw_values"}, "2d"),
    ("R2Score", {"num_outputs": OUTPUTS, "multioutput": "variance_weighted"}, "2d"),
    ("R2Score", {"adjusted": 2}, "1d"),
    ("SpearmanCorrCoef", {}, "1d"),
    ("SpearmanCorrCoef", {}, "ratings"),
    ("SpearmanCorrCoef", {"capacity": 128}, "ratings"),
    ("SpearmanCorrCoef", {"capacity": 50}, "1d"),  # overflows
    ("TweedieDevianceScore", {}, "1d"),
    ("TweedieDevianceScore", {"power": 1}, "nonneg"),
    ("TweedieDevianceScore", {"power": 1.5}, "nonneg"),
    ("TweedieDevianceScore", {"power": 2}, "positive"),
    ("TweedieDevianceScore", {"power": 3}, "positive"),
    ("TweedieDevianceScore", {"power": -0.5}, "positive"),
]


@pytest.mark.parametrize(("name", "kwargs", "kind"), CASES, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)])
def test_module_matches_jax(name, kwargs, kind):
    with _quiet():
        run_twins(getattr(mtt, name)(device="cpu", **kwargs), getattr(mt, name)(**kwargs), kind)


FUNCTIONAL = [
    ("mean_squared_error", {}, "1d"),
    ("mean_squared_error", {"squared": False}, "1d"),
    ("mean_squared_error", {"num_outputs": OUTPUTS}, "2d"),
    ("mean_absolute_error", {}, "1d"),
    ("mean_squared_log_error", {}, "positive"),
    ("mean_absolute_percentage_error", {}, "1d"),
    ("symmetric_mean_absolute_percentage_error", {}, "1d"),
    ("weighted_mean_absolute_percentage_error", {}, "1d"),
    ("cosine_similarity", {"reduction": "sum"}, "rows"),
    ("cosine_similarity", {"reduction": "none"}, "rows"),
    ("explained_variance", {"multioutput": "raw_values"}, "2d"),
    ("explained_variance", {"multioutput": "variance_weighted"}, "2d"),
    ("pearson_corrcoef", {}, "1d"),
    ("r2_score", {}, "1d"),
    ("r2_score", {"multioutput": "raw_values"}, "2d"),
    ("r2_score", {"adjusted": 3}, "1d"),
    ("spearman_corrcoef", {}, "ratings"),
    ("tweedie_deviance_score", {"power": 0}, "1d"),
    ("tweedie_deviance_score", {"power": 1}, "nonneg"),
    ("tweedie_deviance_score", {"power": 1.5}, "nonneg"),
    ("tweedie_deviance_score", {"power": 2}, "positive"),
]


@pytest.mark.parametrize(("name", "kwargs", "kind"), FUNCTIONAL, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(FUNCTIONAL)])
def test_functional_matches_jax(name, kwargs, kind):
    preds, target = _data(kind, 7)
    ours = getattr(tF, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    ref = getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert np_leaf(ours).dtype == np.asarray(ref).dtype
    _values_close(ours, ref)


def test_state_dtypes_are_jax_dtypes():
    for name in ("MeanSquaredError", "MeanAbsoluteError", "MeanSquaredLogError", "MeanAbsolutePercentageError",
                 "SymmetricMeanAbsolutePercentageError", "WeightedMeanAbsolutePercentageError", "ExplainedVariance",
                 "PearsonCorrCoef", "R2Score", "TweedieDevianceScore"):
        ours, ref = getattr(mtt, name)(device="cpu").metric_state, getattr(mt, name)().metric_state
        assert sorted(ours) == sorted(ref), name
        for k in ref:
            assert np_leaf(ours[k]).dtype == np.asarray(ref[k]).dtype, (name, k)


# ties, signed zeros, denormals (which XLA's compare flushes to zero),
# infinities and runs of equal values
EDGE = np.array(
    [0.0, -0.0, 1e-40, -1e-40, 2.5, 2.5, np.inf, np.inf, -np.inf, 1.0, 1.0, 1.0, -3.0, 7.0, 1e-45, 0.5],
    dtype=np.float32,
)


@pytest.mark.parametrize("masked", [False, True])
def test_rank_data_exact_on_edge_values(masked):
    rng = np.random.default_rng(3)
    mask = rng.random(EDGE.size) < 0.7 if masked else None
    ours = torch_rank_data(torch.from_numpy(EDGE), None if mask is None else torch.from_numpy(mask))
    ref = jax_rank_data(jnp.asarray(EDGE), None if mask is None else jnp.asarray(mask))
    keep = np.ones(EDGE.size, bool) if mask is None else mask
    assert np_leaf(ours).dtype == np.float32
    np.testing.assert_array_equal(np_leaf(ours)[keep], np.asarray(ref)[keep])


@pytest.mark.parametrize("capacity", [None, 32, 20])
def test_spearman_on_edge_values_both_modes(capacity):
    rng = np.random.default_rng(5)
    target = rng.permutation(EDGE)
    ours = mtt.SpearmanCorrCoef(capacity=capacity, device="cpu")
    ref = mt.SpearmanCorrCoef(capacity=capacity)
    with _quiet():
        for half in (slice(0, 8), slice(8, 16)):
            ours.update(torch.from_numpy(EDGE[half]), torch.from_numpy(target[half]))
            ref.update(jnp.asarray(EDGE[half]), jnp.asarray(target[half]))
            assert_states_close(ours.metric_state, ref.metric_state)
        np.testing.assert_allclose(np_leaf(ours.compute()), np.asarray(ref.compute()), rtol=RTOL, atol=ATOL)


def test_spearman_valid_mask_and_plus_inf_data():
    """A ring with +inf data and masked rows: the ``<=`` count is capped at
    the valid rows, so the padding does not tie with the +inf rows."""
    x = np.array([np.inf, 1.0, np.inf, 2.0, 0.0, 5.0], np.float32)
    y = np.array([3.0, 1.0, 2.0, np.inf, 0.0, 4.0], np.float32)
    valid = np.array([True, True, True, False, True, True])
    ours = mtt.SpearmanCorrCoef(capacity=16, device="cpu")
    ref = mt.SpearmanCorrCoef(capacity=16)
    ours.update(torch.from_numpy(x), torch.from_numpy(y), valid=torch.from_numpy(valid))
    ref.update(jnp.asarray(x), jnp.asarray(y), valid=jnp.asarray(valid))
    assert_states_close(ours.metric_state, ref.metric_state)
    np.testing.assert_allclose(np_leaf(ours.compute()), np.asarray(ref.compute()), rtol=RTOL, atol=ATOL)


def test_empty_spearman_ring_is_nan():
    with _quiet():  # compute before update
        assert bool(torch.isnan(mtt.SpearmanCorrCoef(capacity=8, device="cpu").compute()))


def _moments(world, seed=9):
    """Per-rank Pearson moments of ragged shards, stacked in rank order."""
    preds, target = _data("1d", seed, n=60)
    bounds = np.cumsum([0] + [10, 25, 7, 18][:world])
    rows = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        m = mt.PearsonCorrCoef()
        m.update(jnp.asarray(preds[a:b]), jnp.asarray(target[a:b]))
        rows.append([np.asarray(m.metric_state[k]) for k in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")])
    return [np.stack(col) for col in zip(*rows)], preds[: bounds[-1]], target[: bounds[-1]]


@pytest.mark.parametrize("world", [2, 4])
def test_pearson_final_aggregation_on_stacked_moments(world):
    stacked, preds, target = _moments(world)
    ours = torch_final_aggregation(*(torch.from_numpy(s) for s in stacked))
    ref = jax_final_aggregation(*(jnp.asarray(s) for s in stacked))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(np_leaf(o), np.asarray(r), rtol=RTOL, atol=ATOL)
    # a metric holding the stacked moments (a synced state) merges them
    m = mtt.PearsonCorrCoef(device="cpu")
    for k, s in zip(("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"), stacked):
        m._state[k] = torch.from_numpy(s)
    m._update_called = True
    want = np.corrcoef(preds.astype(np.float64), target.astype(np.float64))[0, 1]
    np.testing.assert_allclose(float(m.compute()), want, rtol=1e-5)


def _grad_pair(name, kind, kwargs):
    preds, target = _data(kind, 11)
    p = torch.from_numpy(preds).requires_grad_(True)
    (g_ours,) = torch.autograd.grad(getattr(tF, name)(p, torch.from_numpy(target), **kwargs), p)
    g_ref = jax.grad(lambda x: getattr(jF, name)(x, jnp.asarray(target), **kwargs))(jnp.asarray(preds))
    return np_leaf(g_ours), np.asarray(g_ref)


@pytest.mark.parametrize(
    ("name", "kind", "kwargs"),
    [
        ("mean_squared_error", "1d", {}),
        ("mean_squared_error", "1d", {"squared": False}),
        ("mean_absolute_error", "1d", {}),
        ("explained_variance", "1d", {}),
        ("cosine_similarity", "rows", {"reduction": "mean"}),
    ],
)
def test_gradients_match_jax_grad(name, kind, kwargs):
    ours, ref = _grad_pair(name, kind, kwargs)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_module_value_is_differentiable_through_update():
    preds, target = _data("1d", 12)
    p = torch.from_numpy(preds).requires_grad_(True)
    m = mtt.MeanSquaredError(device="cpu")
    m.update(p, torch.from_numpy(target))
    (g,) = torch.autograd.grad(m.compute(), p)
    np.testing.assert_allclose(np_leaf(g), 2 * (preds - target) / preds.size, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize(
    ("factory", "match"),
    [
        (lambda pkg, **kw: pkg.MeanSquaredError(squared=1, **kw), "squared"),
        (lambda pkg, **kw: pkg.CosineSimilarity(reduction="max", **kw), "reduction"),
        (lambda pkg, **kw: pkg.ExplainedVariance(multioutput="x", **kw), "multioutput"),
        (lambda pkg, **kw: pkg.R2Score(adjusted=-1, **kw), "adjusted"),
        (lambda pkg, **kw: pkg.TweedieDevianceScore(power=0.5, **kw), "power"),
    ],
)
def test_constructor_refusals_match_jax(factory, match):
    with pytest.raises(ValueError, match=match):
        factory(mt)
    with pytest.raises(ValueError, match=match):
        factory(mtt, device="cpu")


@pytest.mark.parametrize(
    ("fn", "args"),
    [
        ("tweedie_deviance_score", ([1.0, -1.0], [1.0, 1.0], 1)),
        ("tweedie_deviance_score", ([1.0, 1.0], [0.0, 1.0], 2)),
        ("spearman_corrcoef", ([1.0, 2.0], [[1.0, 2.0]])),
        ("r2_score", ([1.0], [1.0])),
        ("pearson_corrcoef", ([[1.0, 2.0], [3.0, 4.0]], [[1.0, 2.0], [3.0, 4.0]])),
    ],
)
def test_functional_value_refusals_match_jax(fn, args):
    tensors = [np.asarray(a, np.float32) for a in args[:2]]
    rest = args[2:]
    with pytest.raises((ValueError, RuntimeError, TypeError)):
        getattr(jF, fn)(*(jnp.asarray(t) for t in tensors), *rest)
    with pytest.raises((ValueError, RuntimeError, TypeError)):
        getattr(tF, fn)(*(torch.from_numpy(t) for t in tensors), *rest)
