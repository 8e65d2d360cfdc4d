"""The port's aggregators (``metrics_tpu_torch/aggregation.py``) against the
JAX package on the same seeded numpy streams, with NaN rows, under every
``nan_strategy``.

Tolerances (W4): ``MaxMetric``, ``MinMetric`` and ``CatMetric`` exact;
``SumMetric`` and ``MeanMetric`` within ``SUM_ATOL`` plus ``SUM_RTOL``, since their float32
sums run in another order (a mean merges by adding its value and weight
sums, so a merge weighs each part by its count); fault counts exact.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402

# float32 sums of up to 192 terms below 12 in magnitude, added in another
# order: a few units in the last place of the terms (absolute) or of the sum
# (relative)
SUM_ATOL = 2e-5
SUM_RTOL = 1e-6
TOL = {"MaxMetric": 0.0, "MinMetric": 0.0, "CatMetric": 0.0, "SumMetric": SUM_ATOL, "MeanMetric": SUM_ATOL}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, ref, atol):
    o, r = _np(ours), np.asarray(ref)
    assert o.shape == r.shape and o.dtype == r.dtype, (o.shape, r.shape, o.dtype, r.dtype)
    if atol:
        np.testing.assert_allclose(o, r, rtol=SUM_RTOL, atol=atol)
    else:
        np.testing.assert_array_equal(o, r)


def _stream(seed, n=64, nan_share=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32) * 3
    x[rng.random(n) < nan_share] = np.nan
    return x


def _compare_states(ours, ref, atol):
    for k, r in ref.metric_state.items():
        if k == "_faults":
            assert ours.fault_counts == {name: int(v) for name, v in r.as_dict().items()}
            continue
        o = ours.metric_state[k]
        if isinstance(r, list):
            _close(torch.cat(o) if o else torch.zeros(0), np.concatenate([np.asarray(v) for v in r]) if r else np.zeros(0, np.float32), 0.0)
        elif hasattr(r, "mask"):
            for field in ("data", "mask", "dropped"):
                _close(getattr(o, field), getattr(r, field), 0.0)
        else:
            _close(o, r, atol)


def run_twins(name, kwargs, seeds=(0, 1, 2), weights=False):
    atol = TOL[name]
    ours, ref = getattr(mtt, name)(device="cpu", **kwargs), getattr(mt, name)(**kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, seed in enumerate(seeds):
            x = _stream(seed)
            args_t, args_j = [torch.from_numpy(x)], [jnp.asarray(x)]
            if weights:
                w = np.abs(_stream(seed + 100, nan_share=0.05))
                args_t.append(torch.from_numpy(w))
                args_j.append(jnp.asarray(w))
            if i == 1:
                _close(ours(*args_t), ref(*args_j), atol)
            else:
                ours.update(*args_t)
                ref.update(*args_j)
            _compare_states(ours, ref, atol)
        _close(ours.compute(), ref.compute(), atol)


STRATEGIES = ["warn", "ignore", 0.5]


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", ["MaxMetric", "MinMetric", "SumMetric", "MeanMetric", "CatMetric"])
def test_aggregators_match_jax(name, strategy):
    run_twins(name, {"nan_strategy": strategy})


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
def test_weighted_mean_matches_jax(strategy):
    run_twins("MeanMetric", {"nan_strategy": strategy}, weights=True)


@pytest.mark.parametrize("capacity", [16, 256])
@pytest.mark.parametrize("strategy", ["warn", 0.5])
def test_ring_cat_metric_matches_jax(capacity, strategy):
    run_twins("CatMetric", {"nan_strategy": strategy, "capacity": capacity})


@pytest.mark.parametrize("name", ["MaxMetric", "MinMetric", "SumMetric", "MeanMetric", "CatMetric"])
def test_error_strategy_raises_like_jax(name):
    x = _stream(3, nan_share=0.5)
    with pytest.raises(RuntimeError, match="nan"):
        getattr(mtt, name)(nan_strategy="error", device="cpu").update(torch.from_numpy(x))
    with pytest.raises(RuntimeError, match="nan"):
        getattr(mt, name)(nan_strategy="error").update(jnp.asarray(x))


def test_list_cat_metric_warns_at_update_and_unguarded_warn_at_update():
    with pytest.warns(UserWarning, match="Will be removed"):
        mtt.CatMetric(device="cpu").update(torch.tensor([1.0, float("nan")]))
    m = mtt.MeanMetric(nan_strategy="warn", on_invalid="ignore", device="cpu")
    with pytest.warns(UserWarning, match="Will be removed"):
        m.update(torch.tensor([1.0, float("nan")]), torch.tensor([float("nan"), 1.0]))
    assert np.isnan(float(m.compute()))  # both rows masked: 0 / 0


def test_mean_merge_is_count_weighted():
    """A forward merges a batch by its sums: the mean of 3 rows and of 1
    row is the mean of the 4."""
    m = mtt.MeanMetric(device="cpu")
    m.update(torch.tensor([1.0, 2.0, 3.0]))
    m(torch.tensor([10.0]))
    assert float(m.compute()) == 4.0
    assert m.fault_counts == {k: 0 for k in m.fault_counts}


def test_bad_strategy_is_refused():
    with pytest.raises(ValueError, match="nan_strategy"):
        mtt.SumMetric(nan_strategy="skip", device="cpu")


@pytest.mark.parametrize("name", ["MaxMetric", "SumMetric", "MeanMetric"])
def test_jax_aggregator_state_carries_over(name):
    """``interop.load_jax_state`` takes a JAX aggregator's state, its fault
    counters included, and both packages go on to the same value."""
    ref = getattr(mt, name)()
    ours = getattr(mtt, name)(device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.update(jnp.asarray(_stream(5)))
        load_jax_state(ours, {k: v for k, v in ref.metric_state.items()})
        assert ours.fault_counts == {k: int(v) for k, v in ref.metric_state["_faults"].as_dict().items()}
        x = _stream(6)
        ours.update(torch.from_numpy(x))
        ref.update(jnp.asarray(x))
        _close(ours.compute(), ref.compute(), TOL[name])
    assert ours.fault_counts == {k: int(v) for k, v in ref.metric_state["_faults"].as_dict().items()}


def test_jax_ring_cat_metric_state_carries_over():
    ref, ours = mt.CatMetric(capacity=32), mtt.CatMetric(capacity=32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.update(jnp.asarray(_stream(7, n=20)))
        load_jax_state(ours, dict(ref.metric_state))
        x = _stream(8, n=20)
        ours.update(torch.from_numpy(x))
        ref.update(jnp.asarray(x))
        _close(ours.compute(), ref.compute(), 0.0)
