"""Float32 denormals and signed zeros in the port's threshold compares,
against the JAX package on the same seeded numpy inputs.

XLA on the CPU (and the TPU) compares with denormals flushed to zero, so a
score or a threshold of ``1e-40`` compares as ``0.0`` there, and ``-0.0``
equals ``0.0`` everywhere. The port routes its threshold compares through
``ops/bucketed_rank.py::flush_denormals`` to match. Counts and states must be
equal exactly; average precision holds to ``atol=1e-6`` (float32 sums over
thresholds, added in another order)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.functional import accuracy as jax_accuracy  # noqa: E402
from metrics_tpu.functional.classification.auc import auc as jax_auc  # noqa: E402
from metrics_tpu.ops import binned_counter_update as jax_binned  # noqa: E402
from metrics_tpu.utilities.data import select_topk as jax_topk  # noqa: E402
from metrics_tpu_torch.functional.classification import accuracy as port_accuracy  # noqa: E402
from metrics_tpu_torch.ops import binned_counters as port_binned  # noqa: E402
from metrics_tpu_torch.utilities.data import select_topk  # noqa: E402

AP_ATOL = 1e-6  # float32 sums over thresholds, added in another order

F32_MIN = np.finfo(np.float32).tiny  # the smallest normal float32
# scores around zero: denormals of both signs, the smallest denormal, both
# zeros, the smallest normal, and ordinary probabilities
POOL = np.array(
    [-1e-40, 1e-40, 2e-39, -2e-39, 1e-45, -1e-45, -0.0, 0.0, F32_MIN, -F32_MIN, 0.3, 0.7, 1.0], np.float32
)
THRESHOLDS = [0.0, 1e-41, 0.5]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scores(shape, seed):
    return np.random.default_rng(seed).choice(POOL, size=shape).astype(np.float32)


def _assert_states_equal(ours, ref):
    for key, r in ref.metric_state.items():
        o = _np(ours.metric_state[key])
        assert o.dtype == np.asarray(r).dtype, key
        np.testing.assert_array_equal(o, np.asarray(r))


def _close(got, want, atol):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _twins(ours, ref, batches, atol=0.0):
    """``update``, ``forward``, ``update`` on both; states equal after each
    call, the forward value and ``compute()`` within ``atol``."""
    for i, (preds, target) in enumerate(batches):
        if i == 1:
            _close(ours(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)), atol)
        else:
            ours.update(torch.from_numpy(preds), torch.from_numpy(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        _assert_states_equal(ours, ref)
    _close(ours.compute(), ref.compute(), atol)


def test_accuracy_threshold_at_zero_and_at_a_denormal():
    preds = np.array([-1e-40, 1e-40, -0.0, 0.7], np.float32)
    target = np.array([1, 1, 1, 0])
    for threshold in (0.0, 1e-41):
        ours = port_accuracy(torch.from_numpy(preds), torch.from_numpy(target), threshold=threshold)
        ref = jax_accuracy(jnp.asarray(preds), jnp.asarray(target), threshold=threshold)
        assert float(ours) == float(ref) == 0.75


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_binary_accuracy(threshold):
    batches = [(_scores(40, s), np.random.default_rng(s).integers(0, 2, 40)) for s in range(3)]
    _twins(mtt.Accuracy(threshold=threshold, device="cpu"), mt.Accuracy(threshold=threshold), batches)


@pytest.mark.parametrize("reduce", ["micro", "macro"])
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_multilabel_stat_scores(reduce, threshold):
    c = 5
    batches = [(_scores((30, c), 10 + s), np.random.default_rng(s).integers(0, 2, (30, c))) for s in range(3)]
    kwargs = dict(reduce=reduce, num_classes=c, threshold=threshold)
    _twins(mtt.StatScores(device="cpu", **kwargs), mt.StatScores(**kwargs), batches)


def test_multiclass_argmax_ties_denormals_with_zero():
    """Top-1 is an argmax, which XLA evaluates with denormals flushed: a
    denormal ties with zero and the lower index wins. Top-k above 1 is
    ``lax.top_k``, which does not flush; the port's stable sort agrees."""
    preds = np.array([[0.0, 1e-40, -1e-40], [-1e-40, 0.0, 1e-40], [1e-40, 2e-40, -0.0], [-0.0, 0.0, -1.0]], np.float32)
    for k in (1, 2):
        np.testing.assert_array_equal(_np(select_topk(torch.from_numpy(preds), k)), np.asarray(jax_topk(jnp.asarray(preds), k)))
    batches = [(_scores((24, 4), 20 + s), np.random.default_rng(s).integers(0, 4, 24)) for s in range(3)]
    _twins(mtt.Accuracy(num_classes=4, device="cpu"), mt.Accuracy(num_classes=4), batches)


def test_binned_counters_with_denormal_scores_and_thresholds():
    preds = np.array([[-1e-40], [1e-40], [-0.0], [0.5]], np.float32)
    target = np.array([[1], [1], [1], [0]], np.float32)
    thresholds = np.array([0.0, 1e-41, 0.5], np.float32)
    tps, _, fns = port_binned.binned_counter_update_plain(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    np.testing.assert_array_equal(_np(tps)[0], [3, 3, 0])
    np.testing.assert_array_equal(_np(fns)[0], [0, 0, 3])

    rng = np.random.default_rng(7)
    preds = _scores((64, 6), 7)
    target = (rng.random((64, 6)) < 0.4).astype(np.float32)
    thresholds = np.array([0.0, 1e-41, -1e-41, -0.0, 2e-39, F32_MIN, 1e-45, 0.3, 0.5, np.nan, 1.0, -1.0], np.float32)
    ours = port_binned.binned_counter_update_plain(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    args = (jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds))
    for ref in (jax_binned(*args, interpret=True), jax_binned(*args, backend="xla")):
        for got, want in zip(ours, ref):
            np.testing.assert_array_equal(_np(got).view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("name", ["BinnedPrecisionRecallCurve", "BinnedAveragePrecision"])
@pytest.mark.parametrize("thresholds", [5, [0.0, 1e-41, -0.0, 0.5, 2e-39]])
def test_binned_metrics(name, thresholds):
    batches = [(_scores(36, 30 + s), np.random.default_rng(s).integers(0, 2, 36)) for s in range(3)]
    kwargs = dict(num_classes=1, thresholds=thresholds)
    _twins(getattr(mtt, name)(device="cpu", **kwargs), getattr(mt, name)(**kwargs), batches, atol=AP_ATOL)


def test_binned_curve_with_denormal_scores():
    preds = np.array([-1e-40, 1e-40, 2e-39, 0.7, 0.2, -0.0], np.float32)
    target = np.array([1, 1, 0, 1, 0, 1])
    ours, ref = mtt.BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device="cpu"), mt.BinnedPrecisionRecallCurve(num_classes=1, thresholds=5)
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    for got, want in zip(ours.compute(), ref.compute()):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize(
    "x",
    [[0.0, 1e-40, 0.0, 1.0], [0.0, 1.5e-38, 1.2e-38, 1.0], [1.0, 2e-38, 1e-38, 0.0], [0.0, -0.0, 0.5, 1.0]],
)
def test_auc_direction_with_denormal_steps(x):
    """The direction check compares each step of ``x`` with zero; a step
    that is a denormal (or the difference of two normals that is one)
    counts as zero in XLA."""
    x = np.array(x, np.float32)
    y = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    auc_module = importlib.import_module("metrics_tpu_torch.functional.classification.auc")
    ours = auc_module.auc(torch.from_numpy(x), torch.from_numpy(y))
    ref = jax_auc(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=0, atol=1e-6)
    assert np.isnan(_np(ours)) == np.isnan(np.asarray(ref))


def test_quantile_sketch_states_with_denormal_streams():
    """The sketch's precompaction maps ``-0.0`` and denormals onto ``+0.0``'s
    key, so its states are bit-equal to JAX's on a stream that is 30 %
    denormals and signed zeros."""
    rng = np.random.default_rng(11)
    ours, ref = mtt.QuantileSketch(k=64, levels=7, device="cpu"), mt.QuantileSketch(k=64, levels=7)
    for i, n in enumerate([500, 64, 3000, 7, 1200]):
        x = rng.lognormal(size=n).astype(np.float32)
        pick = rng.random(n) < 0.3
        x[pick] = rng.choice(POOL[:8], size=int(pick.sum()))
        if i % 2:
            _close(ours(torch.from_numpy(x)), ref(jnp.asarray(x)), 0.0)
        else:
            ours.update(torch.from_numpy(x))
            ref.update(jnp.asarray(x))
        for o, r in zip(ours.metric_state["sketch"], ref.metric_state["sketch"]):
            np.testing.assert_array_equal(_np(o).reshape(-1).view(np.uint8), np.asarray(r).reshape(-1).view(np.uint8))
    _close(ours.compute(), ref.compute(), 0.0)
