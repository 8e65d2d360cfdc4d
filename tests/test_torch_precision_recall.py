"""``Precision``, ``Recall``, ``FBetaScore`` and ``F1Score`` of the port,
and their functional forms, against the JAX package on the same seeded
numpy inputs: every ``average`` and ``mdmc_average``, ``top_k``,
``ignore_index`` and classes absent from a batch.

States are compared by value and dtype after every ``update``/``forward``;
``compute()`` and each ``forward`` value within ``ATOL``: float32 ratios,
summed over classes in another order for the macro and weighted averages,
and exact in practice for micro."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.functional as jf  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch.functional import classification as tf  # noqa: E402

ATOL = 1e-6  # float32 ratios, added over classes in another order
C = 5
N = 24
X = 3  # the extra dimension of multidim inputs


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(ours, ref):
    if isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _same(o, r)
        return
    o, r = _np(ours), _np(ref)
    assert o.shape == r.shape, (o.shape, r.shape)
    np.testing.assert_allclose(o, r, rtol=0, atol=ATOL)


def _same_states(ours, ref):
    ref_state, our_state = ref.metric_state, ours.metric_state
    assert set(our_state) == set(ref_state)
    for k, r in ref_state.items():
        o = our_state[k]
        pairs = list(zip(o, r)) if isinstance(r, list) else [(o, r)]
        assert not isinstance(r, list) or len(o) == len(r)
        for oi, ri in pairs:
            assert _np(oi).dtype == np.asarray(ri).dtype, k
            np.testing.assert_array_equal(_np(oi), np.asarray(ri))


def _data(kind, seed, n=N):
    """Seeded inputs; ``absent`` leaves classes 3 and 4 out of preds and
    target."""
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return rng.random(n).astype(np.float32), rng.integers(0, 2, n)
    if kind == "multiclass":
        p = rng.random((n, C)).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.integers(0, C, n)
    if kind == "absent":
        return rng.integers(0, 3, n), rng.integers(0, 3, n)
    if kind == "labels":
        return rng.integers(0, C, n), rng.integers(0, C, n)
    if kind == "multilabel":
        return rng.random((n, C)).astype(np.float32), rng.integers(0, 2, (n, C))
    if kind == "multidim":
        p = rng.random((n, C, X)).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.integers(0, C, (n, X))
    raise ValueError(kind)


def run_twins(ours, ref, kind, ops=("update", "forward", "update")):
    for i, op in enumerate(ops):
        preds, target = _data(kind, 10 + i, n=N - 5 * (i == len(ops) - 1))
        tp, tt, jp, jt = torch.from_numpy(preds), torch.from_numpy(target), jnp.asarray(preds), jnp.asarray(target)
        if op == "update":
            ours.update(tp, tt)
            ref.update(jp, jt)
        else:
            _same(ours(tp, tt), ref(jp, jt))
        _same_states(ours, ref)
    _same(ours.compute(), ref.compute())


AVERAGES = ["micro", "macro", "weighted", "none"]
CASES = (
    [(dict(num_classes=C, average=a), "multiclass") for a in AVERAGES]
    + [(dict(num_classes=C, average=a), "absent") for a in AVERAGES]
    + [(dict(num_classes=C, average=a, top_k=2), "multiclass") for a in ("micro", "macro")]
    + [(dict(num_classes=C, average=a, ignore_index=1), "labels") for a in AVERAGES]
    + [(dict(average="samples"), "multilabel"), (dict(num_classes=C, average="macro"), "multilabel"), (dict(), "binary")]
    + [(dict(num_classes=C, average=a, mdmc_average=m), "multidim") for a in ("micro", "macro") for m in ("global", "samplewise")]
    + [(dict(num_classes=C, average="weighted", mdmc_average="global"), "multidim")]
)
METRICS = ["Precision", "Recall", "F1Score", "FBetaScore"]


def _kw(name, kwargs):
    return {**kwargs, "beta": 0.5} if name == "FBetaScore" else kwargs


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize(("kwargs", "kind"), CASES, ids=[f"{k}-{i}" for i, (_, k) in enumerate(CASES)])
def test_module_matches_jax(name, kwargs, kind):
    kw = _kw(name, kwargs)
    run_twins(getattr(mtt, name)(device="cpu", **kw), getattr(mt, name)(**kw), kind)


FUNCTIONAL = ["precision", "recall", "f1_score", "fbeta_score", "precision_recall"]


@pytest.mark.parametrize("name", FUNCTIONAL)
@pytest.mark.parametrize(("kwargs", "kind"), CASES, ids=[f"{k}-{i}" for i, (_, k) in enumerate(CASES)])
def test_functional_matches_jax(name, kwargs, kind):
    kw = {**kwargs, "beta": 2.0} if name == "fbeta_score" else kwargs
    preds, target = _data(kind, 3)
    ours = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    _same(ours, getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kw))


def test_absent_class_is_nan_under_none_and_left_out_of_macro():
    """The ``-1`` sentinel: classes 3 and 4 never occur."""
    preds, target = _data("absent", 0)
    per_class = tf.precision(torch.from_numpy(preds), torch.from_numpy(target), average="none", num_classes=C)
    assert bool(torch.isnan(per_class[3:]).all()) and bool(torch.isfinite(per_class[:3]).all())
    macro = tf.precision(torch.from_numpy(preds), torch.from_numpy(target), average="macro", num_classes=C)
    assert abs(float(macro) - float(per_class[:3].mean())) <= ATOL


@pytest.mark.parametrize(
    "kwargs",
    [dict(average="median"), dict(mdmc_average="all"), dict(average="macro"), dict(num_classes=3, ignore_index=3)],
)
def test_argument_errors_match_jax(kwargs):
    preds, target = _data("labels", 0)
    with pytest.raises(ValueError) as ref_err:
        jf.precision(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    with pytest.raises(ValueError) as our_err:
        tf.precision(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert str(our_err.value) == str(ref_err.value)
    with pytest.raises(ValueError):
        mtt.Recall(device="cpu", average="median")
