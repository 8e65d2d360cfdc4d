"""The confusion-matrix family of the port (``ConfusionMatrix``,
``CohenKappa``, ``MatthewsCorrCoef``, ``JaccardIndex``) and the stat-scores
ratios built beside it (``Specificity``, ``Dice``, ``HammingDistance``)
against their JAX twins, on the same seeded numpy inputs.

After every ``update``/``forward`` the states must be equal by value and
dtype, and each ``forward`` must return the JAX batch value. Tolerances:
exact for confusion matrices and counts; ``SUM_ATOL`` for the float32
values computed from them (kappa, MCC, Jaccard and the macro/weighted
ratios sum over C classes or C^2 cells in another order, stated difference
D2). The fault channel is held against JAX under each ``on_invalid``
policy, with NaN scores and labels out of range.
"""
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.functional as jF  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.functional.classification as tF  # noqa: E402
from metrics_tpu_torch.utilities.data import _bincount  # noqa: E402
from tests.test_torch_classification import _np, assert_same, assert_states_equal  # noqa: E402

EXACT = 0.0
SUM_ATOL = 1e-6  # float32 sums over classes or cells, added in another order (D2)

N = 48
C = 5


def _data(kind, seed, n=N, c=C):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return rng.random(n).astype(np.float32), rng.integers(0, 2, n)
    if kind == "multiclass":
        logits = rng.normal(size=(n, c)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), rng.integers(0, c, n)
    if kind == "labels":
        return rng.integers(0, c, n), rng.integers(0, c, n)
    if kind == "multilabel":
        return rng.random((n, c)).astype(np.float32), rng.integers(0, 2, (n, c))
    if kind == "mdmc":
        logits = rng.normal(size=(n, c, 3)).astype(np.float32)
        return logits, rng.integers(0, c, (n, 3))
    raise ValueError(kind)


def assert_guarded_states_equal(ours, ref):
    """As ``assert_states_equal``, with the fault counters by value (int64
    here, uint32 in JAX: stated difference D11)."""
    o, r = ours.metric_state, ref.metric_state
    np.testing.assert_array_equal(_np(o["_faults"].counts), np.asarray(r["_faults"].counts))
    for k in r:
        if k != "_faults":
            assert _np(o[k]).dtype == np.asarray(r[k]).dtype, k
            np.testing.assert_array_equal(_np(o[k]), np.asarray(r[k]))


def run_twins(ours, ref, kind, atol=EXACT, ops=("forward", "update", "forward", "update"), seed=0):
    for i, op in enumerate(ops):
        preds, target = _data(kind, seed + i, n=N - 7 * (i == len(ops) - 1))
        if op == "update":
            ours.update(torch.from_numpy(preds), torch.from_numpy(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        else:
            assert_same(ours(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)), atol)
        assert_states_equal(ours, ref)
    assert_same(ours.compute(), ref.compute(), atol)


CASES = [
    ("ConfusionMatrix", dict(num_classes=C), "multiclass", EXACT),
    ("ConfusionMatrix", dict(num_classes=C), "labels", EXACT),
    ("ConfusionMatrix", dict(num_classes=2), "binary", EXACT),
    ("ConfusionMatrix", dict(num_classes=C, multilabel=True), "multilabel", EXACT),
    ("ConfusionMatrix", dict(num_classes=C), "mdmc", EXACT),
    ("ConfusionMatrix", dict(num_classes=C, normalize="true"), "multiclass", SUM_ATOL),
    ("ConfusionMatrix", dict(num_classes=C, normalize="pred"), "labels", SUM_ATOL),
    ("ConfusionMatrix", dict(num_classes=C, normalize="all"), "multiclass", SUM_ATOL),
    ("CohenKappa", dict(num_classes=C), "multiclass", SUM_ATOL),
    ("CohenKappa", dict(num_classes=C, weights="linear"), "labels", SUM_ATOL),
    ("CohenKappa", dict(num_classes=C, weights="quadratic"), "multiclass", SUM_ATOL),
    ("MatthewsCorrCoef", dict(num_classes=C), "multiclass", SUM_ATOL),
    ("MatthewsCorrCoef", dict(num_classes=2), "binary", SUM_ATOL),
    ("JaccardIndex", dict(num_classes=C), "multiclass", SUM_ATOL),
    ("JaccardIndex", dict(num_classes=C, average="micro"), "labels", SUM_ATOL),
    ("JaccardIndex", dict(num_classes=C, average="weighted"), "multiclass", SUM_ATOL),
    ("JaccardIndex", dict(num_classes=C, average="none", ignore_index=2), "multiclass", SUM_ATOL),
    ("JaccardIndex", dict(num_classes=C, ignore_index=0, absent_score=0.5), "labels", SUM_ATOL),
    ("Specificity", dict(), "binary", EXACT),
    ("Specificity", dict(num_classes=C, average="macro"), "multiclass", SUM_ATOL),
    ("Specificity", dict(num_classes=C, average="weighted"), "labels", SUM_ATOL),
    ("Specificity", dict(num_classes=C, average="none"), "multilabel", SUM_ATOL),
    ("Specificity", dict(num_classes=C, average="samples"), "multilabel", SUM_ATOL),
    ("Specificity", dict(num_classes=C, average="macro", ignore_index=1), "multiclass", SUM_ATOL),
    ("Dice", dict(), "multiclass", EXACT),
    ("Dice", dict(num_classes=C, average="macro"), "multiclass", SUM_ATOL),
    ("Dice", dict(num_classes=C, average="weighted", zero_division=1), "labels", SUM_ATOL),
    ("Dice", dict(num_classes=C, average="none"), "multilabel", SUM_ATOL),
    ("Dice", dict(num_classes=C, average="macro", mdmc_average="global"), "mdmc", SUM_ATOL),
    ("HammingDistance", dict(), "multiclass", EXACT),
    ("HammingDistance", dict(), "multilabel", EXACT),
    ("HammingDistance", dict(threshold=0.3), "binary", EXACT),
]


@pytest.mark.parametrize(("name", "kwargs", "kind", "atol"), CASES, ids=[f"{n}-{k}-{i}" for i, (n, _, k, _) in enumerate(CASES)])
def test_module_matches_jax(name, kwargs, kind, atol):
    run_twins(getattr(mtt, name)(device="cpu", **kwargs), getattr(mt, name)(**kwargs), kind, atol)


FUNCTIONAL = [
    ("confusion_matrix", dict(num_classes=C), "multiclass", EXACT),
    ("confusion_matrix", dict(num_classes=C, normalize="true"), "labels", SUM_ATOL),
    ("confusion_matrix", dict(num_classes=C, multilabel=True), "multilabel", EXACT),
    ("cohen_kappa", dict(num_classes=C, weights="quadratic"), "multiclass", SUM_ATOL),
    ("matthews_corrcoef", dict(num_classes=C), "labels", SUM_ATOL),
    ("jaccard_index", dict(num_classes=C, average="none"), "multiclass", SUM_ATOL),
    ("specificity", dict(num_classes=C, average="macro"), "multiclass", SUM_ATOL),
    ("specificity", dict(num_classes=C, average="none", mdmc_average="samplewise"), "mdmc", SUM_ATOL),
    ("dice", dict(num_classes=C, average="macro"), "labels", SUM_ATOL),
    ("dice", dict(), "multilabel", EXACT),
    ("hamming_distance", dict(), "multilabel", EXACT),
]


@pytest.mark.parametrize(("name", "kwargs", "kind", "atol"), FUNCTIONAL, ids=[f"{n}-{k}-{i}" for i, (n, _, k, _) in enumerate(FUNCTIONAL)])
def test_functional_matches_jax(name, kwargs, kind, atol):
    preds, target = _data(kind, seed=7)
    ours = getattr(tF, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert_same(ours, getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs), atol)


def test_normalize_nan_rows_warn_and_become_zero_as_in_jax():
    # class 4 never occurs as a label nor as a prediction: its row and column are empty
    preds = np.array([0, 1, 2, 3, 0, 1]), np.array([0, 1, 2, 3, 1, 0])
    for normalize in ("true", "pred"):
        with pytest.warns(UserWarning, match="nan values found in confusion matrix") as ours_w:
            ours = tF.confusion_matrix(torch.from_numpy(preds[0]), torch.from_numpy(preds[1]), 5, normalize=normalize)
        with pytest.warns(UserWarning) as ref_w:
            ref = jF.confusion_matrix(jnp.asarray(preds[0]), jnp.asarray(preds[1]), 5, normalize=normalize)
        assert str(ours_w[0].message) == str(ref_w[0].message)
        assert_same(ours, ref)


@pytest.mark.parametrize("policy", ["warn", "drop", "error"])
@pytest.mark.parametrize("name", ["ConfusionMatrix", "CohenKappa", "MatthewsCorrCoef", "JaccardIndex", "HammingDistance"])
def test_fault_channel_matches_jax(name, policy):
    """NaN score rows and labels at or above C, counted (and under "drop"
    masked) exactly as in JAX; states stay equal after every update."""
    kwargs = {} if name == "HammingDistance" else {"num_classes": C}
    ours = getattr(mtt, name)(device="cpu", on_invalid=policy, **kwargs)
    ref = getattr(mt, name)(on_invalid=policy, **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for seed in range(3):
            preds, target = _data("multiclass", seed)
            preds[seed :: 9] = np.nan
            target[1 + seed :: 11] = C + seed
            ours.update(torch.from_numpy(preds), torch.from_numpy(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
            assert_guarded_states_equal(ours, ref)
        assert ours.fault_counts == ref.metric_state["_faults"].as_dict()
        if policy == "error":
            with pytest.raises(Exception) as ours_err:
                ours.compute()
            with pytest.raises(Exception):
                ref.compute()
            assert "faults detected" in str(ours_err.value)
        else:
            assert_same(ours.compute(), ref.compute(), SUM_ATOL)


def test_unguarded_nan_scores_match_jax():
    """``on_invalid="ignore"`` (D1: the value checks run): NaN score rows
    count as their argmax does in JAX."""
    ours, ref = mtt.ConfusionMatrix(C, device="cpu"), mt.ConfusionMatrix(C)
    preds, target = _data("multiclass", 5)
    preds[::4] = np.nan
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert_states_equal(ours, ref)


def test_confmat_members_form_one_compute_group_and_count_once(monkeypatch):
    """ConfusionMatrix, CohenKappa, MatthewsCorrCoef and JaccardIndex of one
    class count hold one state: after the first batch the collection updates
    the group's head only, so the counts run once per batch (on the card,
    one K2 launch)."""
    # the package re-exports the function under the module's name
    cm_mod = importlib.import_module("metrics_tpu_torch.functional.classification.confusion_matrix")
    calls = []

    def counting(x, minlength):
        calls.append(minlength)
        return _bincount(x, minlength)

    monkeypatch.setattr(cm_mod, "_bincount", counting)
    members = dict(cm=mtt.ConfusionMatrix(C, device="cpu"), kappa=mtt.CohenKappa(C, device="cpu"),
                   mcc=mtt.MatthewsCorrCoef(C, device="cpu"), jaccard=mtt.JaccardIndex(C, device="cpu"))
    ours = mtt.MetricCollection(members)
    ref = mt.MetricCollection(dict(cm=mt.ConfusionMatrix(C), kappa=mt.CohenKappa(C), mcc=mt.MatthewsCorrCoef(C), jaccard=mt.JaccardIndex(C)))
    for seed in range(4):
        preds, target = _data("multiclass", seed)
        ours.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert [sorted(g) for g in ours.compute_groups.values()] == [["cm", "jaccard", "kappa", "mcc"]]
    assert calls == [C * C] * (4 + 3)  # every member on the first batch, the head after
    got, want = ours.compute(), ref.compute()
    for k in want:
        assert_same(got[k], want[k], EXACT if k == "cm" else SUM_ATOL)


@pytest.mark.parametrize(
    ("x", "minlength"),
    [
        (np.array([0, 3, 3, -1, 7, 2**31 + 3, 5], np.int64), 6),
        (np.arange(-4, 40, dtype=np.int32) % 13, 12),
        (np.zeros((0,), np.int32), 4),
    ],
)
def test_bincount_counts_the_range_only_as_jax(x, minlength):
    from metrics_tpu.utilities.data import _bincount as jax_bincount

    ours = _bincount(torch.from_numpy(x), minlength)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(_np(ours), np.asarray(jax_bincount(jnp.asarray(x.astype(np.int64)), minlength)))


def test_forward_full_state_property_probe_recommends_a_flag(capsys):
    from metrics_tpu_torch.utilities.checks import check_forward_full_state_property

    rng = np.random.default_rng(0)
    check_forward_full_state_property(
        mtt.ConfusionMatrix,
        init_args={"num_classes": 3, "device": "cpu"},
        input_args={"preds": torch.from_numpy(rng.integers(3, size=10)), "target": torch.from_numpy(rng.integers(3, size=10))},
        num_update_to_compare=(2, 4),
        reps=2,
    )
    out = capsys.readouterr().out
    assert "Full state for 2 steps took:" in out and "Recommended setting `full_state_update=" in out


def test_same_shape_check_matches_jax():
    from metrics_tpu.utilities.checks import _check_same_shape as jax_check
    from metrics_tpu_torch.utilities.checks import _check_same_shape

    with pytest.raises(RuntimeError) as ours:
        _check_same_shape(torch.zeros(3), torch.zeros(4))
    with pytest.raises(RuntimeError) as ref:
        jax_check(jnp.zeros(3), jnp.zeros(4))
    assert str(ours.value) == str(ref.value)
