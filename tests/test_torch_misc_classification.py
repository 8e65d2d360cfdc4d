"""``CalibrationError``, ``HingeLoss`` and ``KLDivergence`` of the port
against their JAX twins, on the same seeded numpy inputs.

Tolerances: ``bin_count`` and every count are exact. Every float32 state
and value is held to ``FLOAT_RTOL`` plus ``SUM_ATOL``: the bin sums
(``bin_conf``, ``bin_acc``) and the hinge and KL sums add their rows in
another order (``index_add_`` on the card adds with atomics, in no fixed
order), and a sigmoid, softmax or log rounds its last bit differently from
XLA's. Confidences equal to the bin edges, denormal and signed-zero
confidences land in the bins where XLA puts them, so the counts stay exact.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.functional as jF  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.functional.classification as tF  # noqa: E402
from tests.test_torch_classification import _np, assert_same  # noqa: E402

SUM_ATOL = 1e-6  # float32 values near or below 1: sums over rows or bins in another order
FLOAT_RTOL = 1e-6  # float32 sums of many rows, and exp/log/softmax rounding

N = 64
C = 6


def _data(kind, seed, n=N, c=C):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return rng.random(n).astype(np.float32), rng.integers(0, 2, n)
    if kind == "binary_logits":
        return rng.normal(size=n).astype(np.float32) * 3, rng.integers(0, 2, n)
    if kind == "multiclass":
        logits = rng.normal(size=(n, c)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), rng.integers(0, c, n)
    if kind == "logits":
        return rng.normal(size=(n, c)).astype(np.float32) * 2, rng.integers(0, c, n)
    if kind == "mdmc":
        logits = rng.normal(size=(n, c, 3)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), rng.integers(0, c, (n, 3))
    if kind == "edges":
        # every bin edge of 15 bins as JAX computes it, the denormals and
        # signed zeros around 0, and 1.0 itself
        edges = np.asarray(jnp.linspace(0, 1, 16, dtype=jnp.float32))
        specials = np.array([1e-40, -1e-40, 0.0, -0.0, 1.0, np.nextafter(np.float32(1 / 15), 0)], np.float32)
        p = np.concatenate([edges, specials, rng.random(n - 22).astype(np.float32)])
        return p.astype(np.float32), rng.integers(0, 2, n)
    raise ValueError(kind)


def _close(ours, ref, exact=False):
    o, r = _np(ours), np.asarray(ref)
    assert o.dtype == r.dtype and o.shape == r.shape, (o.dtype, r.dtype, o.shape, r.shape)
    if exact or not np.issubdtype(r.dtype, np.floating):
        np.testing.assert_array_equal(o, r)
    else:
        np.testing.assert_allclose(o, r, rtol=FLOAT_RTOL, atol=SUM_ATOL, equal_nan=True)


def _close_states(ours, ref):
    o, r = ours.metric_state, ref.metric_state
    assert set(o) == set(r)
    for k, rv in r.items():
        ov = o[k]
        if k == "_faults":
            np.testing.assert_array_equal(_np(ov.counts), np.asarray(rv.counts))
        elif isinstance(rv, list):
            assert len(ov) == len(rv)
            for a, b in zip(ov, rv):
                _close(a, b)
        elif hasattr(rv, "mask"):  # a ring
            for f in ("data", "mask", "dropped"):
                _close(getattr(ov, f), getattr(rv, f))
        else:
            _close(ov, rv, exact=k == "bin_count")


def run_twins(ours, ref, kind, ops=("forward", "update", "update"), valid=False, seed=0):
    for i, op in enumerate(ops):
        a, b = _data(kind, seed + i, n=N - 5 * (i == len(ops) - 1))
        kw_ours, kw_ref = {}, {}
        if valid:
            v = np.random.default_rng(100 + i).random(a.shape[0]) < 0.8
            kw_ours, kw_ref = {"valid": torch.from_numpy(v)}, {"valid": jnp.asarray(v)}
        if op == "update":
            ours.update(torch.from_numpy(a), torch.from_numpy(b), **kw_ours)
            ref.update(jnp.asarray(a), jnp.asarray(b), **kw_ref)
        else:
            got = ours(torch.from_numpy(a), torch.from_numpy(b), **kw_ours)
            want = ref(jnp.asarray(a), jnp.asarray(b), **kw_ref)
            _close(got, want)
        _close_states(ours, ref)
    _close(ours.compute(), ref.compute())


CALIBRATION = [
    (dict(), "binary"),
    (dict(n_bins=10, norm="l2"), "multiclass"),
    (dict(norm="max"), "logits"),
    (dict(binned=True), "binary_logits"),
    (dict(binned=True, norm="l2"), "mdmc"),
    (dict(binned=True), "edges"),
    (dict(), "edges"),
]


@pytest.mark.parametrize(("kwargs", "kind"), CALIBRATION, ids=[f"{k}-{i}" for i, (_, k) in enumerate(CALIBRATION)])
def test_calibration_error_matches_jax(kwargs, kind):
    run_twins(mtt.CalibrationError(device="cpu", **kwargs), mt.CalibrationError(**kwargs), kind)


def test_binned_calibration_takes_a_valid_mask_as_jax():
    run_twins(mtt.CalibrationError(binned=True, device="cpu"), mt.CalibrationError(binned=True), "multiclass", valid=True)


@pytest.mark.parametrize("policy", ["warn", "drop"])
def test_calibration_fault_channel_matches_jax(policy):
    ours = mtt.CalibrationError(binned=True, on_invalid=policy, device="cpu")
    ref = mt.CalibrationError(binned=True, on_invalid=policy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for seed in range(3):
            p, t = _data("multiclass", seed)
            p[seed::7] = np.nan
            t[2 + seed :: 13] = C + 1
            ours.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))
            _close_states(ours, ref)
        assert ours.fault_counts == ref.metric_state["_faults"].as_dict()
        _close(ours.compute(), ref.compute())


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_functional_calibration_error_matches_jax(norm):
    p, t = _data("edges", 3)
    assert_same(tF.calibration_error(torch.from_numpy(p), torch.from_numpy(t), n_bins=15, norm=norm),
                jF.calibration_error(jnp.asarray(p), jnp.asarray(t), n_bins=15, norm=norm), SUM_ATOL)


def test_bin_counts_at_the_edges_are_exact():
    from metrics_tpu.functional.classification.calibration_error import _ce_bin_update as jax_bins
    from metrics_tpu_torch.functional.classification.calibration_error import _ce_bin_update

    p, t = _data("edges", 1)
    acc = t.astype(np.float32)
    ours = _ce_bin_update(torch.from_numpy(p), torch.from_numpy(acc), 15)
    ref = jax_bins(jnp.asarray(p), jnp.asarray(acc), 15)
    np.testing.assert_array_equal(_np(ours[0]), np.asarray(ref[0]))
    for o, r in zip(ours[1:], ref[1:]):
        _close(o, r)


HINGE = [
    (dict(), "binary_logits"),
    (dict(squared=True), "binary_logits"),
    (dict(), "logits"),
    (dict(multiclass_mode="crammer-singer", squared=True), "logits"),
    (dict(multiclass_mode="one-vs-all"), "logits"),
    (dict(multiclass_mode="one-vs-all", squared=True), "multiclass"),
]


@pytest.mark.parametrize(("kwargs", "kind"), HINGE, ids=[f"{k}-{i}" for i, (_, k) in enumerate(HINGE)])
def test_hinge_matches_jax(kwargs, kind):
    run_twins(mtt.HingeLoss(device="cpu", **kwargs), mt.HingeLoss(**kwargs), kind)
    a, b = _data(kind, 9)
    _close(tF.hinge_loss(torch.from_numpy(a), torch.from_numpy(b), **kwargs), jF.hinge_loss(jnp.asarray(a), jnp.asarray(b), **kwargs))


def test_hinge_refuses_an_unknown_mode_as_jax():
    with pytest.raises(ValueError) as ours:
        mtt.HingeLoss(multiclass_mode="all-vs-one", device="cpu")
    with pytest.raises(ValueError) as ref:
        mt.HingeLoss(multiclass_mode="all-vs-one")
    assert str(ours.value) == str(ref.value)


def _dists(seed, n=N, c=C, log=False):
    rng = np.random.default_rng(seed)
    p = rng.random((n, c)).astype(np.float32) + 0.01
    q = rng.random((n, c)).astype(np.float32) + 0.01
    if log:
        p = np.log(p / p.sum(1, keepdims=True)).astype(np.float32)
        q = np.log(q / q.sum(1, keepdims=True)).astype(np.float32)
    return p, q


KL = [dict(), dict(reduction="sum"), dict(log_prob=True), dict(reduction="none"), dict(reduction="none", capacity=256)]
# a list state takes no valid mask (both packages refuse one)
KL_CASES = [(k, v) for k in KL for v in (False, True) if not (v and k == dict(reduction="none"))]


@pytest.mark.parametrize(
    ("kwargs", "valid"), KL_CASES, ids=[("-".join(f"{a}={b}" for a, b in k.items()) or "mean") + ("-valid" if v else "") for k, v in KL_CASES]
)
def test_kl_divergence_matches_jax(kwargs, valid):
    ours, ref = mtt.KLDivergence(device="cpu", **kwargs), mt.KLDivergence(**kwargs)
    log = kwargs.get("log_prob", False)
    for i, op in enumerate(("forward", "update", "update")):
        p, q = _dists(i, n=N - 9 * i, log=log)
        if valid:
            p[::5] = np.nan  # invalid rows may hold NaN: they are selected away
        kw = {}
        if valid:
            v = np.ones(p.shape[0], bool)
            v[::5] = False
            kw = {"valid": v}
        args_o = (torch.from_numpy(p), torch.from_numpy(q))
        args_r = (jnp.asarray(p), jnp.asarray(q))
        kw_o = {k: torch.from_numpy(x) for k, x in kw.items()}
        kw_r = {k: jnp.asarray(x) for k, x in kw.items()}
        if op == "update":
            ours.update(*args_o, **kw_o)
            ref.update(*args_r, **kw_r)
        else:
            _close(ours(*args_o, **kw_o), ref(*args_r, **kw_r))
        _close_states(ours, ref)
    _close(ours.compute(), ref.compute())


def test_functional_kl_divergence_matches_jax():
    p, q = _dists(4)
    for reduction in ("mean", "sum", "none"):
        _close(tF.kl_divergence(torch.from_numpy(p), torch.from_numpy(q), reduction=reduction),
               jF.kl_divergence(jnp.asarray(p), jnp.asarray(q), reduction=reduction))
    with pytest.raises(RuntimeError, match="same shape"):
        tF.kl_divergence(torch.from_numpy(p), torch.from_numpy(q[:, :3]))
