"""``StatScores``, ``Accuracy`` and the three Binned metrics of the port
against their JAX twins, on the same seeded numpy inputs.

After every ``update``/``forward`` the states must be equal by value and
dtype, and each ``forward`` must return the JAX batch value. ``compute()``
tolerances: exact for counts and for accuracy over all samples; ``atol=1e-6``
where a float32 sum runs over classes or thresholds (accuracy averaged over
classes, average precision, recall-at-precision), because the two packages
add in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.functional import accuracy as jax_accuracy  # noqa: E402
from metrics_tpu_torch.functional.classification import accuracy as torch_accuracy  # noqa: E402

EXACT = 0.0
SUM_ATOL = 1e-6  # float32 sums over classes or thresholds, added in another order

BATCH = 32
C = 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(ours, ref, atol=EXACT):
    """Equal structure and values; ``atol=0`` demands exact equality."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(ours, (list, tuple)) and len(ours) == len(ref)
        for o, r in zip(ours, ref):
            assert_same(o, r, atol)
        return
    o, r = _np(ours), _np(ref)
    assert o.shape == r.shape, (o.shape, r.shape)
    if atol == EXACT:
        np.testing.assert_array_equal(o, r)
    else:
        np.testing.assert_allclose(o, r, rtol=0, atol=atol)


def assert_states_equal(ours, ref):
    ref_state = ref.metric_state
    ours_state = ours.metric_state
    assert set(ours_state) == set(ref_state)
    for k, r in ref_state.items():
        o = ours_state[k]
        if isinstance(r, list):
            assert len(o) == len(r)
            for oi, ri in zip(o, r):
                assert _np(oi).dtype == np.asarray(ri).dtype
                np.testing.assert_array_equal(_np(oi), np.asarray(ri))
        else:
            assert _np(o).dtype == np.asarray(r).dtype, k
            np.testing.assert_array_equal(_np(o), np.asarray(r))


def _data(kind, seed, n=BATCH, c=C):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return rng.random(n).astype(np.float32), rng.integers(0, 2, n)
    if kind == "multiclass":
        logits = rng.normal(size=(n, c)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), rng.integers(0, c, n)
    if kind == "multilabel":
        return rng.random((n, c)).astype(np.float32), rng.integers(0, 2, (n, c))
    if kind == "labels":
        return rng.integers(0, c, n), rng.integers(0, c, n)
    if kind == "ties":
        # scores on a coarse grid: many rows tie in their top entries
        return (rng.integers(0, 3, (n, c)) / 4).astype(np.float32), rng.integers(0, c, n)
    raise ValueError(kind)


def run_twins(ours, ref, kind, ops=("update", "forward", "update"), atol=EXACT, seed=0):
    for i, op in enumerate(ops):
        preds, target = _data(kind, seed + i, n=BATCH - 5 * (i == len(ops) - 1))
        if op == "update":
            ours.update(torch.from_numpy(preds), torch.from_numpy(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        else:
            assert_same(ours(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)), atol)
        assert_states_equal(ours, ref)
    assert_same(ours.compute(), ref.compute(), atol)


CASES = [
    ("StatScores", dict(), "binary"),
    ("StatScores", dict(reduce="macro", num_classes=C), "multiclass"),
    ("StatScores", dict(reduce="macro", num_classes=C), "multilabel"),
    ("StatScores", dict(reduce="micro", top_k=2), "multiclass"),
    ("StatScores", dict(reduce="samples"), "multilabel"),
    ("StatScores", dict(reduce="macro", num_classes=C, ignore_index=1), "multiclass"),
    ("Accuracy", dict(), "binary"),
    ("Accuracy", dict(num_classes=C), "multiclass"),
    ("Accuracy", dict(num_classes=C, average="macro"), "multiclass"),
    ("Accuracy", dict(num_classes=C, average="none"), "multiclass"),
    ("Accuracy", dict(num_classes=C, average="weighted"), "multiclass"),
    ("Accuracy", dict(), "multilabel"),
    ("Accuracy", dict(subset_accuracy=True), "multilabel"),
    ("Accuracy", dict(num_classes=C), "labels"),
    ("Accuracy", dict(num_classes=C, top_k=5), "multiclass"),
    ("Accuracy", dict(num_classes=C, top_k=3), "ties"),
    ("Accuracy", dict(num_classes=C), "ties"),
    ("Accuracy", dict(num_classes=C, average="samples"), "multiclass"),
]


def _atol(kwargs):
    return SUM_ATOL if kwargs.get("average") in ("macro", "weighted") else EXACT


@pytest.mark.parametrize(("name", "kwargs", "kind"), CASES, ids=[f"{n}-{k}-{i}" for i, (n, _, k) in enumerate(CASES)])
def test_stat_metrics_match_jax(name, kwargs, kind):
    run_twins(getattr(mtt, name)(device="cpu", **kwargs), getattr(mt, name)(**kwargs), kind, atol=_atol(kwargs))


BINNED = [
    ("BinnedPrecisionRecallCurve", dict(num_classes=C, thresholds=11), "multiclass"),
    ("BinnedPrecisionRecallCurve", dict(num_classes=1, thresholds=5), "binary"),
    ("BinnedAveragePrecision", dict(num_classes=C, thresholds=100), "multiclass"),
    ("BinnedAveragePrecision", dict(num_classes=1, thresholds=25), "binary"),
    ("BinnedAveragePrecision", dict(num_classes=C, thresholds=[0.9, 0.05, 0.5, 0.5, 0.2]), "multilabel"),
    ("BinnedRecallAtFixedPrecision", dict(num_classes=C, thresholds=11, min_precision=0.3), "multiclass"),
    ("BinnedRecallAtFixedPrecision", dict(num_classes=1, thresholds=10, min_precision=0.5), "binary"),
    ("BinnedRecallAtFixedPrecision", dict(num_classes=C, thresholds=11, min_precision=0.99), "multilabel"),
]


@pytest.mark.parametrize(("name", "kwargs", "kind"), BINNED, ids=[f"{n}-{k}-{i}" for i, (n, _, k) in enumerate(BINNED)])
def test_binned_metrics_match_jax(name, kwargs, kind):
    run_twins(getattr(mtt, name)(device="cpu", **kwargs), getattr(mt, name)(**kwargs), kind, atol=SUM_ATOL)


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_top_k_breaks_ties_toward_the_lower_index(top_k):
    preds = np.array([[0.2, 0.2, 0.2, 0.2, 0.1], [0.0, 0.3, 0.3, 0.1, 0.3]], np.float32)
    from metrics_tpu.utilities.data import select_topk as jax_topk
    from metrics_tpu_torch.utilities.data import select_topk

    np.testing.assert_array_equal(select_topk(torch.from_numpy(preds), top_k).numpy(), np.asarray(jax_topk(jnp.asarray(preds), top_k)))


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(average="macro", num_classes=C), dict(top_k=2), dict(average="none", num_classes=C), dict(mdmc_average="samplewise")],
)
def test_functional_accuracy_matches_jax(kwargs):
    kind = "multiclass" if kwargs.get("top_k") else "labels"
    preds, target = _data(kind, seed=42)
    if "mdmc_average" in kwargs:
        preds, target = _data("labels", seed=42, n=BATCH * 4)
        preds, target = preds.reshape(BATCH, 4), target.reshape(BATCH, 4)
    ours = torch_accuracy(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert_same(ours, jax_accuracy(jnp.asarray(preds), jnp.asarray(target), **kwargs), _atol(kwargs))


@pytest.mark.parametrize(
    ("kwargs", "preds", "target"),
    [
        (dict(), np.array([0.1, 0.9]), np.array([0.0, 1.0])),  # float target
        (dict(num_classes=3), np.array([0, 1]), np.array([0, 3])),  # label >= num_classes
        (dict(top_k=1), np.array([0.1, 0.9]), np.array([0, 1])),  # top_k on binary data
        (dict(), np.array([0, 1, 2]), np.array([0, 1])),  # first dimensions differ
    ],
)
def test_input_errors_match_jax(kwargs, preds, target):
    """The eager functional form: the JAX module skips value checks inside
    its compiled update, the port (always eager) never does."""
    with pytest.raises(ValueError) as ref_err:
        jax_accuracy(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    with pytest.raises(ValueError) as our_err:
        torch_accuracy(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert str(our_err.value) == str(ref_err.value)
