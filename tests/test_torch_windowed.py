"""The port's windowed and decayed wrappers
(``metrics_tpu_torch/streaming/windowed.py``) against the JAX package's
(``metrics_tpu/streaming/windowed.py``), in the cases of
``tests/streaming/test_windowed.py`` (less the ``functionalize`` cases,
which wait for the port's ``pure.py``).

Each case feeds the same seeded numpy batches to both packages. Window
values, ``window_rows``, counts and fault counts are compared exactly; a
decayed mean sums its batch in another order than JAX (W4), so it is held
to ``rtol=1e-6`` of JAX and of the float64 closed form. A JAX wrapper's
state (the bucket rings and cursor, the decayed sums) loads into the port
with ``interop.load_jax_state`` and goes on there.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402

MEAN_RTOL = 1e-6  # a float32 sum of a batch, taken in another order than JAX's (W4)


def _acc_stream(seed=11, total=400, classes=4):
    rng = np.random.default_rng(seed)
    return rng.random((total, classes)).astype(np.float32), rng.integers(0, classes, total).astype(np.int32)


def _both(make):
    """``make(pkg, **device)`` for the JAX package and the port on the CPU."""
    return make(mt), make(mtt, device="cpu")


def _update(pair, *arrays):
    jm, tm = pair
    jm.update(*[jnp.asarray(a) for a in arrays])
    tm.update(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _values(pair):
    jm, tm = pair
    jm._computed = tm._computed = None
    return float(jm.compute()), float(tm.compute())


@pytest.mark.parametrize("batch", [8, 16])
def test_window_parity_with_jax_and_the_trailing_rows(batch):
    W, B = 64, 4
    preds, target = _acc_stream(total=10 * W // 4)
    pair = _both(lambda pkg, **d: pkg.WindowedMetric(pkg.Accuracy(num_classes=4, **d), window=W, buckets=B))
    exact = mtt.Accuracy(num_classes=4, device="cpu")
    for i in range(0, len(preds) - batch + 1, batch):
        _update(pair, preds[i:i + batch], target[i:i + batch])
        seen = i + batch
        covered = pair[1].window_rows
        assert covered == pair[0].window_rows and covered in (min(seen, W), min(seen, W - pair[1].bucket_len + batch))
        exact.reset()
        exact.update(torch.from_numpy(preds[seen - covered:seen]), torch.from_numpy(target[seen - covered:seen]))
        jv, tv = _values(pair)
        assert jv == tv == float(exact.compute())
    for key, value in pair[0].metric_state.items():
        assert np.array_equal(np.asarray(value), pair[1].metric_state[key].numpy()), key


def test_window_full_coverage_and_reset():
    W, B = 32, 4
    preds, target = _acc_stream(total=10 * W)
    pair = _both(lambda pkg, **d: pkg.WindowedMetric(pkg.Accuracy(num_classes=4, **d), window=W, buckets=B))
    L = pair[1].bucket_len
    for i in range(0, 10 * W, L):
        _update(pair, preds[i:i + L], target[i:i + L])
    assert pair[1].window_rows == W == pair[0].window_rows
    jv, tv = _values(pair)
    exact = mtt.Accuracy(num_classes=4, device="cpu")
    exact.update(torch.from_numpy(preds[-W:]), torch.from_numpy(target[-W:]))
    assert jv == tv == float(exact.compute())
    for m in pair:
        m.reset()
    assert pair[1].window_rows == 0
    _update(pair, preds[:W], target[:W])
    assert _values(pair)[0] == _values(pair)[1]


def test_windowed_mean_and_minmax_states():
    pair = _both(lambda pkg, **d: pkg.WindowedMetric(pkg.MeanMetric(nan_strategy="ignore", **d), window=4, buckets=2))
    for batch in ([1.0, 1.0], [2.0, 2.0], [8.0, 8.0]):
        _update(pair, np.asarray(batch, np.float32))
    assert _values(pair) == (5.0, 5.0)
    pair = _both(lambda pkg, **d: pkg.WindowedMetric(pkg.MaxMetric(nan_strategy="ignore", **d), window=4, buckets=2))
    for batch in ([9.0, 9.0], [1.0, 1.0], [2.0, 2.0]):
        _update(pair, np.asarray(batch, np.float32))
    assert _values(pair) == (2.0, 2.0)  # the 9s rotated out


def test_decayed_mean_against_jax_and_the_closed_form():
    rng = np.random.default_rng(14)
    xs = rng.random(64).astype(np.float32)
    h = 7.0
    pair = _both(lambda pkg, **d: pkg.DecayedMetric(pkg.MeanMetric(nan_strategy="ignore", **d), halflife=h))
    for v in xs:
        _update(pair, np.asarray([v]))
    ages = np.arange(len(xs) - 1, -1, -1, dtype=np.float64)
    w = 2.0 ** (-ages / h)
    expect = float((w * xs).sum() / w.sum())
    jv, tv = _values(pair)
    # one row per update: every float32 operation is JAX's, in JAX's order
    assert tv == jv
    np.testing.assert_allclose(tv, expect, rtol=1e-5)
    for key, value in pair[0].metric_state.items():
        assert np.array_equal(np.asarray(value), pair[1].metric_state[key].numpy()), key


def test_decayed_mean_of_batches_within_mean_rtol():
    rng = np.random.default_rng(15)
    pair = _both(lambda pkg, **d: pkg.DecayedMetric(pkg.MeanMetric(nan_strategy="ignore", **d), halflife=64.0))
    for _ in range(5):
        _update(pair, rng.random(16).astype(np.float32))
    jv, tv = _values(pair)
    np.testing.assert_allclose(tv, jv, rtol=MEAN_RTOL)


def test_decayed_accuracy_tracks_the_recent_stream():
    ones = np.ones((16,), np.int32)
    p_right = np.stack([np.zeros(16, np.float32), np.ones(16, np.float32)], axis=1)
    pair = _both(lambda pkg, **d: pkg.DecayedMetric(pkg.Accuracy(num_classes=2, **d), halflife=8.0))
    _update(pair, np.ascontiguousarray(p_right[:, ::-1]), ones)
    for _ in range(4):
        _update(pair, p_right, ones)
    jv, tv = _values(pair)
    assert tv == jv and tv > 0.9


def test_windowed_fault_counters_expire_with_their_bucket():
    pair = _both(lambda pkg, **d: pkg.WindowedMetric(pkg.MeanMetric(nan_strategy="warn", **d), window=4, buckets=2))
    with pytest.warns(UserWarning):
        _update(pair, np.asarray([1.0, np.nan], np.float32))
        _values(pair)
    assert pair[1].fault_counts == pair[0].fault_counts and pair[1].fault_counts["dropped_rows"] == 1
    for _ in range(3):
        _update(pair, np.asarray([1.0, 2.0], np.float32))
    assert pair[1].fault_counts == pair[0].fault_counts and pair[1].fault_counts["dropped_rows"] == 0
    assert np.isfinite(_values(pair)[1])


@pytest.mark.parametrize("policy", ["warn", "drop"])
def test_wrapper_guard_faults_counted_once(policy):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pair = _both(lambda pkg, **d: pkg.WindowedMetric(pkg.MeanMetric(**d), window=8, buckets=2, on_invalid=policy))
        _update(pair, np.asarray([1.0, np.nan, 3.0], np.float32))
        assert pair[1].fault_counts == pair[0].fault_counts and pair[1].fault_counts["nonfinite_preds"] == 1
        assert _values(pair) == (2.0, 2.0)


def test_decayed_fault_counters_do_not_decay():
    pair = _both(lambda pkg, **d: pkg.DecayedMetric(pkg.MeanMetric(nan_strategy="warn", **d), halflife=1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _update(pair, np.asarray([1.0, np.nan], np.float32))
        for _ in range(10):
            _update(pair, np.asarray([1.0, 2.0], np.float32))
    assert pair[1].fault_counts == pair[0].fault_counts and pair[1].fault_counts["dropped_rows"] == 1
    with pytest.raises(RuntimeError, match="nan"):
        mtt.DecayedMetric(mtt.MeanMetric(nan_strategy="error", device="cpu"), halflife=1.0).update(torch.tensor([float("nan")]))


def test_wrappers_refuse_what_jax_refuses():
    for pkg, d in ((mt, {}), (mtt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="per-row/list/sketch"):
            pkg.WindowedMetric(pkg.AUROC(capacity=64, **d), window=8, buckets=2)
        with pytest.raises(ValueError, match="per-row/list/sketch"):
            pkg.WindowedMetric(pkg.CatMetric(**d), window=8, buckets=2)
        with pytest.raises(ValueError, match="per-row/list/sketch"):
            pkg.WindowedMetric(pkg.QuantileSketch(eps=0.1, max_items=1 << 12, **d), window=8, buckets=2)
        with pytest.raises(ValueError, match="no decay rule"):
            pkg.DecayedMetric(pkg.MaxMetric(**d), halflife=4.0)
        with pytest.raises(ValueError, match="divisible"):
            pkg.WindowedMetric(pkg.SumMetric(**d), window=10, buckets=4)
        with pytest.raises(ValueError, match="window"):
            pkg.WindowedMetric(pkg.SumMetric(**d), window=0, buckets=1)
        with pytest.raises(ValueError, match="halflife"):
            pkg.DecayedMetric(pkg.SumMetric(**d), halflife=0.0)
        with pytest.raises(ValueError, match="Metric"):
            pkg.WindowedMetric(object(), window=8, buckets=2)


def test_oversized_batches_warn_once_and_report_the_true_span():
    pair = _both(lambda pkg, **d: pkg.WindowedMetric(pkg.SumMetric(nan_strategy="ignore", **d), window=8, buckets=4))
    batch = np.full((5,), 1.0, np.float32)
    with pytest.warns(UserWarning, match="exceed the 2-row bucket quota"):
        pair[1].update(torch.from_numpy(batch))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        for _ in range(7):
            pair[1].update(torch.from_numpy(batch))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(8):
            pair[0].update(jnp.asarray(batch))
    assert pair[1].window_rows == 20 == pair[0].window_rows
    assert _values(pair) == (20.0, 20.0)


def test_jax_wrapper_state_carries_over():
    """The rings and cursor of a windowed metric, and the float32 sums of a
    decayed one, load into the port, which goes on from them."""
    preds, target = _acc_stream(seed=3, total=120)
    pair = _both(lambda pkg, **d: pkg.WindowedMetric(pkg.Accuracy(num_classes=4, on_invalid="drop", **d), window=32, buckets=4))
    jm, tm = pair
    for i in range(0, 96, 8):
        jm.update(jnp.asarray(preds[i:i + 8]), jnp.asarray(target[i:i + 8]))
    load_jax_state(tm, {k: np.asarray(getattr(v, "counts", v)) for k, v in jm.metric_state.items()})
    for i in range(96, 120, 8):
        _update(pair, preds[i:i + 8], target[i:i + 8])
    assert _values(pair)[0] == _values(pair)[1] and tm.window_rows == jm.window_rows
    for key, value in jm.metric_state.items():
        assert np.array_equal(np.asarray(getattr(value, "counts", value)), tm.metric_state[key].numpy()), key

    rng = np.random.default_rng(4)
    pair = _both(lambda pkg, **d: pkg.DecayedMetric(pkg.MeanMetric(nan_strategy="ignore", **d), halflife=5.0))
    jd, td = pair
    for _ in range(4):
        jd.update(jnp.asarray(rng.random(1).astype(np.float32)))
    load_jax_state(td, {k: np.asarray(getattr(v, "counts", v)) for k, v in jd.metric_state.items()})
    for _ in range(3):
        _update(pair, rng.random(1).astype(np.float32))
    assert _values(pair)[0] == _values(pair)[1]
