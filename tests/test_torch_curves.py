"""The exact-curve metrics of the port against the JAX package: AUROC,
AveragePrecision, ROC, PrecisionRecallCurve and AUC, functional and module,
binary and multiclass, with ``cat`` list states and with ``capacity=``
``CatBuffer`` rings (``valid`` masks, overflow and its ``dropped`` count),
on seeded inputs with ties and ±inf.

Curves (thresholds, fpr, tpr, precision, recall) and states are exact.
Areas (AUROC, AP, AUC) are float32 sums taken in another order: within
``AREA_ATOL``."""
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.functional.classification.auc import _auc_compute_masked as jax_auc_masked  # noqa: E402
from metrics_tpu.functional.classification.auc import auc as jax_auc  # noqa: E402
from metrics_tpu_torch.functional.classification.auc import _auc_compute_masked, auc  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append  # noqa: E402


def _modules(package):
    # the packages re-export functions under their modules' names, so the
    # modules are looked up by their full names
    return [importlib.import_module(f"{package}.functional.classification.{m}")
            for m in ("auroc", "average_precision", "precision_recall_curve", "roc")]


jax_auroc_mod, jax_ap_mod, jax_prc_mod, jax_roc_mod = _modules("metrics_tpu")
auroc_mod, ap_mod, prc_mod, roc_mod = _modules("metrics_tpu_torch")

C = 4
BATCH = 60
AREA_ATOL = 1e-6  # float32 sums over a curve, added in another order


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def assert_same(ours, ref, atol=0.0):
    """Same structure and values; exact (bitwise, NaN equal) when atol is 0."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(ours, (list, tuple)) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert_same(a, b, atol)
        return
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    if atol:
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=0, atol=atol, equal_nan=True)
    else:
        assert a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _binary(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    p = rng.random(n).astype(np.float32)
    pick = rng.random(n)
    p[pick < 0.3] = np.round(p[pick < 0.3], 1)  # ties
    p[(pick >= 0.3) & (pick < 0.33)] = np.inf
    p[(pick >= 0.33) & (pick < 0.36)] = -np.inf
    y = (rng.random(n) < 0.4).astype(np.int32)
    return p, y


def _multiclass(seed, n=BATCH, c=C):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, c))
    p = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    tie = rng.random(n) < 0.3
    p[tie] = np.round(p[tie], 1)  # ties within each class's column
    y = rng.integers(0, c, n).astype(np.int32)
    return p, y


def _data(kind, seed, n=BATCH):
    return _binary(seed, n) if kind == "binary" else _multiclass(seed, n)


def _mask(seed, n, share=0.8):
    return np.random.default_rng(seed + 100).random(n) < share


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


# --------------------------------------------------------------------------
# functional: the eager curves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_curves_match_jax(seed):
    p, y = _binary(seed, 200)
    p[:4] = [0.0, -0.0, 1e-40, -1e-40]  # ties for XLA's subtraction
    assert_same(prc_mod.precision_recall_curve(_t(p), _t(y)), jax_prc_mod.precision_recall_curve(_j(p), _j(y)))
    assert_same(roc_mod.roc(_t(p), _t(y)), jax_roc_mod.roc(_j(p), _j(y)))
    assert_same(auroc_mod.auroc(_t(p), _t(y)), jax_auroc_mod.auroc(_j(p), _j(y)), AREA_ATOL)
    assert_same(ap_mod.average_precision(_t(p), _t(y)), jax_ap_mod.average_precision(_j(p), _j(y)), AREA_ATOL)


def test_integer_scores_and_sample_weights_match_jax():
    rng = np.random.default_rng(5)
    p = rng.integers(-5, 6, 150).astype(np.int32)
    y = (rng.random(150) < 0.5).astype(np.int32)
    w = rng.random(150).astype(np.float32)
    assert_same(prc_mod.precision_recall_curve(_t(p), _t(y)), jax_prc_mod.precision_recall_curve(_j(p), _j(y)))
    assert_same(roc_mod.roc(_t(p), _t(y), sample_weights=_t(w)), jax_roc_mod.roc(_j(p), _j(y), sample_weights=_j(w)), 1e-6)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_multiclass_curves_match_jax(average):
    p, y = _multiclass(3, 150)
    y[y == 2] = 1  # class 2 has no observation
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_same(
            prc_mod.precision_recall_curve(_t(p), _t(y), num_classes=C),
            jax_prc_mod.precision_recall_curve(_j(p), _j(y), num_classes=C),
        )
        assert_same(roc_mod.roc(_t(p), _t(y), num_classes=C), jax_roc_mod.roc(_j(p), _j(y), num_classes=C))
        assert_same(
            auroc_mod.auroc(_t(p), _t(y), num_classes=C, average=average),
            jax_auroc_mod.auroc(_j(p), _j(y), num_classes=C, average=average),
            AREA_ATOL,
        )
        assert_same(
            ap_mod.average_precision(_t(p), _t(y), num_classes=C, average=average),
            jax_ap_mod.average_precision(_j(p), _j(y), num_classes=C, average=average),
            AREA_ATOL,
        )


def test_multilabel_and_partial_auroc_match_jax():
    rng = np.random.default_rng(9)
    p = rng.random((120, 3)).astype(np.float32)
    y = (rng.random((120, 3)) < 0.5).astype(np.int32)
    for average in ("micro", "weighted"):
        assert_same(
            auroc_mod.auroc(_t(p), _t(y), num_classes=3, average=average),
            jax_auroc_mod.auroc(_j(p), _j(y), num_classes=3, average=average),
            AREA_ATOL,
        )
    pb, yb = _binary(4, 300)
    assert_same(auroc_mod.auroc(_t(pb), _t(yb), max_fpr=0.3), jax_auroc_mod.auroc(_j(pb), _j(yb), max_fpr=0.3), AREA_ATOL)


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_matches_jax(reorder):
    rng = np.random.default_rng(12)
    x = np.sort(rng.random(50)).astype(np.float32)
    if reorder:
        x = rng.permutation(x)
    y = rng.random(50).astype(np.float32)
    assert_same(auc(_t(x), _t(y), reorder=reorder), jax_auc(_j(x), _j(y), reorder=reorder), AREA_ATOL)
    assert_same(auc(_t(x[::-1].copy()), _t(y), reorder=reorder), jax_auc(_j(x[::-1]), _j(y), reorder=reorder), AREA_ATOL)


# --------------------------------------------------------------------------
# functional: the masked (ring) forms
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 64), (2, 300)])
def test_binary_masked_forms_match_jax(seed, n):
    p, y = _binary(seed, n)
    p[:3] = [0.0, -0.0, 1e-40][: min(3, n)]  # the comparator's ties
    m = _mask(seed, n)
    args_t, args_j = (_t(p), _t(y), _t(m)), (_j(p), _j(y), _j(m))
    assert_same(prc_mod._binary_precision_recall_curve_masked(*args_t), jax_prc_mod._binary_precision_recall_curve_masked(*args_j))
    assert_same(roc_mod._binary_roc_masked(*args_t), jax_roc_mod._binary_roc_masked(*args_j))
    assert_same(auroc_mod._binary_auroc_masked(*args_t), jax_auroc_mod._binary_auroc_masked(*args_j), AREA_ATOL)
    assert_same(ap_mod._binary_average_precision_masked(*args_t), jax_ap_mod._binary_average_precision_masked(*args_j), AREA_ATOL)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_multiclass_masked_forms_match_jax(average):
    p, y = _multiclass(6, 200)
    y[y == 3] = 0  # class 3 has no positive
    m = _mask(6, 200)
    args_t, args_j = (_t(p), _t(y), _t(m), C), (_j(p), _j(y), _j(m), C)
    assert_same(prc_mod._multiclass_precision_recall_curve_masked(*args_t), jax_prc_mod._multiclass_precision_recall_curve_masked(*args_j))
    assert_same(roc_mod._multiclass_roc_masked(*args_t), jax_roc_mod._multiclass_roc_masked(*args_j))
    assert_same(auroc_mod._multiclass_auroc_masked(*args_t, average), jax_auroc_mod._multiclass_auroc_masked(*args_j, average), AREA_ATOL)
    assert_same(ap_mod._multiclass_average_precision_masked(*args_t, average), jax_ap_mod._multiclass_average_precision_masked(*args_j, average), AREA_ATOL)


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_masked_matches_jax(reorder):
    rng = np.random.default_rng(8)
    x = np.sort(rng.random(80)).astype(np.float32)
    if reorder:
        x = rng.permutation(x)
    y = rng.random(80).astype(np.float32)
    m = _mask(8, 80)
    assert_same(_auc_compute_masked(_t(x), _t(y), _t(m), reorder), jax_auc_masked(_j(x), _j(y), _j(m), reorder), AREA_ATOL)


def test_masked_auroc_equals_the_eager_curve_on_the_valid_rows():
    # finite scores: the eager curve treats each ±inf as its own threshold
    # (inf - inf is NaN, not 0), the rank statistic ties them
    p, y = _binary(11, 400)
    p = np.where(np.isfinite(p), p, 0.5).astype(np.float32)
    m = _mask(11, 400)
    ring = auroc_mod._binary_auroc_masked(_t(p), _t(y), _t(m))
    eager = auroc_mod.auroc(_t(p[m]), _t(y[m]))
    assert abs(float(ring) - float(eager)) <= AREA_ATOL


# --------------------------------------------------------------------------
# the ring
# --------------------------------------------------------------------------


def test_cat_append_matches_jax_with_valid_and_overflow():
    from metrics_tpu.utilities.ringbuffer import CatBuffer as JaxCatBuffer
    from metrics_tpu.utilities.ringbuffer import cat_append as jax_cat_append

    ours, ref = CatBuffer.zeros(10, (2,)), JaxCatBuffer.zeros(10, (2,))
    rng = np.random.default_rng(1)
    for n, masked in [(4, False), (5, True), (6, True), (3, False)]:
        rows = rng.random((n, 2)).astype(np.float32)
        valid = rng.random(n) < 0.6 if masked else None
        ours = cat_append(ours, _t(rows), None if valid is None else _t(valid))
        ref = jax_cat_append(ref, _j(rows), None if valid is None else _j(valid))
        for a, b in zip(ours, (ref.data, ref.mask, ref.dropped)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert int(ours.dropped) > 0


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


def assert_states_equal(ours, ref):
    for key, value in ours.metric_state.items():
        want = ref.metric_state[key]
        if isinstance(value, CatBuffer):
            for a, b in zip(value, (want.data, want.mask, want.dropped)):
                np.testing.assert_array_equal(_np(a), np.asarray(b))
        else:
            assert len(value) == len(want)
            for a, b in zip(value, want):
                np.testing.assert_array_equal(_np(a), np.asarray(b))


def run_twins(ours, ref, kind, atol, valid=False):
    """update, forward, update: states equal after each, the batch value
    and compute() equal."""
    for i, op in enumerate(("update", "forward", "update")):
        p, y = _data(kind, 20 + i, BATCH - 7 * (i == 2))
        kw_t, kw_j = {}, {}
        if valid:
            m = _mask(20 + i, p.shape[0])
            kw_t, kw_j = {"valid": _t(m)}, {"valid": _j(m)}
        if op == "update":
            ours.update(_t(p), _t(y), **kw_t)
            ref.update(_j(p), _j(y), **kw_j)
        else:
            assert_same(ours(_t(p), _t(y), **kw_t), ref(_j(p), _j(y), **kw_j), atol)
        assert_states_equal(ours, ref)
    assert ours.dropped_count == (ref.dropped_count or 0)
    assert_same(ours.compute(), ref.compute(), atol)


MODULES = [
    ("AUROC", {}, "binary", AREA_ATOL),
    ("AUROC", {"num_classes": C}, "multiclass", AREA_ATOL),
    ("AUROC", {"num_classes": C, "average": "weighted"}, "multiclass", AREA_ATOL),
    ("AveragePrecision", {}, "binary", AREA_ATOL),
    ("AveragePrecision", {"num_classes": C, "average": "none"}, "multiclass", AREA_ATOL),
    ("ROC", {}, "binary", 0.0),
    ("ROC", {"num_classes": C}, "multiclass", 0.0),
    ("PrecisionRecallCurve", {}, "binary", 0.0),
    ("PrecisionRecallCurve", {"num_classes": C}, "multiclass", 0.0),
]


@pytest.mark.parametrize("capacity", [None, 512, 200], ids=["cat", "ring", "ring_overflow"])
@pytest.mark.parametrize(("name", "kwargs", "kind", "atol"), MODULES, ids=[f"{n}-{k}-{i}" for i, (n, _, k, _) in enumerate(MODULES)])
def test_curve_modules_match_jax(name, kwargs, kind, atol, capacity):
    kw = dict(kwargs) if capacity is None else {**kwargs, "capacity": capacity, "on_overflow": "ignore"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_twins(getattr(mtt, name)(device="cpu", **kw), getattr(mt, name)(**kw), kind, atol, valid=capacity == 512)


@pytest.mark.parametrize("capacity", [None, 100, 40])
def test_auc_module_matches_jax(capacity):
    kw = {"reorder": True} if capacity is None else {"reorder": True, "capacity": capacity, "on_overflow": "ignore"}
    ours, ref = mtt.AUC(device="cpu", **kw), mt.AUC(**kw)
    rng = np.random.default_rng(4)
    for i in range(3):
        x, y = rng.random(30).astype(np.float32), rng.random(30).astype(np.float32)
        if i == 1:
            assert_same(ours(_t(x), _t(y)), ref(_j(x), _j(y)), AREA_ATOL)
        else:
            ours.update(_t(x), _t(y))
            ref.update(_j(x), _j(y))
    assert ours.dropped_count == (ref.dropped_count or 0)
    assert_same(ours.compute(), ref.compute(), AREA_ATOL)


def test_ring_overflow_warns_raises_and_counts():
    p, y = _binary(30, 100)
    m = mtt.AUROC(capacity=64, device="cpu")
    m.update(_t(p), _t(y))
    assert m.dropped_count == 36
    with pytest.warns(UserWarning, match="36 sample rows exceeded"):
        m.compute()
    strict = mtt.AveragePrecision(capacity=64, on_overflow="error", device="cpu")
    strict.update(_t(p), _t(y))
    with pytest.raises(MetricsTPUUserError, match="36 sample rows"):
        strict.compute()
    with pytest.raises(ValueError, match="only supported in capacity"):
        mtt.AUROC(device="cpu").update(_t(p), _t(y), valid=_t(np.ones(100, bool)))


def test_ring_state_dict_round_trip_and_capacity_checks():
    p, y = _binary(31, 50)
    m = mtt.ROC(capacity=64, device="cpu")
    m.update(_t(p), _t(y))
    m.persistent(True)
    sd = m.state_dict()
    assert set(sd["preds"]) == {"data", "mask", "dropped"}
    other = mtt.ROC(capacity=64, device="cpu")
    other.load_state_dict(sd)
    assert_same(other.compute(), m.compute())
    # a synced union loads at another capacity, both rings alike
    grown = {k: {f: torch.cat([v[f], v[f]]) if f != "dropped" else v[f] for f in v} for k, v in sd.items()}
    other.load_state_dict(grown)
    assert other.metric_state["preds"].capacity == 128
    with pytest.raises(ValueError, match="different capacities"):
        other.load_state_dict({"preds": sd["preds"], "target": grown["target"]})
    with pytest.raises(ValueError, match="row shape|has shape"):
        other.load_state_dict({"preds": {**sd["preds"], "data": torch.zeros(64, 2)}})
    with pytest.raises(ValueError, match="mask length"):
        other.load_state_dict({"preds": {**sd["preds"], "mask": torch.zeros(10, dtype=torch.bool)}})


def test_compute_groups_share_rings_and_lists():
    p, y = _binary(32, 80)
    p = np.where(np.isfinite(p), p, 0.5).astype(np.float32)
    coll = mtt.MetricCollection({
        "auroc": mtt.AUROC(device="cpu"), "ap": mtt.AveragePrecision(device="cpu"),
        "auroc_ring": mtt.AUROC(capacity=256, device="cpu"), "ap_ring": mtt.AveragePrecision(capacity=256, device="cpu"),
    })
    coll.update(_t(p), _t(y))
    coll.update(_t(p[:40]), _t(y[:40]))
    assert sorted(map(sorted, coll.compute_groups.values())) == [["ap", "auroc"], ["ap_ring", "auroc_ring"]]
    res = coll.compute()
    pp, yy = np.concatenate([p, p[:40]]), np.concatenate([y, y[:40]])
    assert abs(float(res["auroc"]) - float(jax_auroc_mod.auroc(_j(pp), _j(yy)))) <= AREA_ATOL
    assert abs(float(res["auroc_ring"]) - float(res["auroc"])) <= AREA_ATOL
    assert abs(float(res["ap_ring"]) - float(res["ap"])) <= AREA_ATOL


@pytest.mark.parametrize("capacity", [None, 128])
def test_jax_curve_state_carries_over(capacity):
    """A JAX metric's state loads into the port (a ring as the JAX
    CatBuffer or as a mapping, a cat state as a list), and both compute the
    same value from it."""
    kw = {} if capacity is None else {"capacity": capacity}
    ref = mt.AveragePrecision(**kw)
    for seed in (40, 41):
        p, y = _binary(seed, 50)
        ref.update(_j(p), _j(y))
    ours = mtt.AveragePrecision(device="cpu", **kw)
    state = dict(ref.metric_state)
    if capacity is not None:
        state["target"] = {"data": np.asarray(state["target"].data), "mask": np.asarray(state["target"].mask),
                           "dropped": np.asarray(state["target"].dropped)}
    load_jax_state(ours, state)
    assert_states_equal(ours, ref)
    # the attributes a cat-mode metric infers from a batch come back with
    # the next update
    p, y = _binary(42, 30)
    ours.update(_t(p), _t(y))
    ref.update(_j(p), _j(y))
    assert_states_equal(ours, ref)
    assert_same(ours.compute(), ref.compute(), AREA_ATOL)
