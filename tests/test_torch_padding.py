"""The padding ladder of the port (``metrics_tpu_torch/ops/padding.py``,
``Metric(pad_batches=True)``) against the JAX package's
``metrics_tpu/ops/padding.py``, on the same inputs.

Held exactly: the tiers of every batch size under the pow-2 and explicit
ladders and the environment variable (with its warn-once fallbacks), the
padded arrays and masks, the pad count, the refusal of a metric that cannot
consume a row mask, and the states of a padded metric (equal to the
unpadded run's, with ``padded_rows`` the pad count, and to the JAX
package's). Also the one row-mask predicate shared by the drop guard and
the ladder: a streaming wrapper forwards ``valid`` to its metric, so a
guarded ``"drop"`` update of ``WindowedMetric(Accuracy)`` masks rows without
reading anything back, as in the JAX package.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.ops.padding as jpad  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.ops.padding as tpad  # noqa: E402
from metrics_tpu.utilities.exceptions import MetricsTPUUserError as JaxUserError  # noqa: E402
from metrics_tpu.utilities.guard import _consumes_valid_mask as jax_consumes  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402
from metrics_tpu_torch.utilities.guard import _consumes_valid_mask, can_drop_traced  # noqa: E402
from tests.helpers.torch_twins import assert_states_close  # noqa: E402
from tests.test_torch_fault_channel import _no_readback  # noqa: E402

C = 4


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_PAD_LADDER", raising=False)
    tpad.reset_padding_state()
    jpad.reset_padding_state()
    yield
    tpad.reset_padding_state()
    jpad.reset_padding_state()


def _rows(n, seed=0, nan_row=None):
    rng = np.random.default_rng(seed)
    p = rng.random((n, C)).astype(np.float32)
    t = rng.integers(0, C, n)
    if nan_row is not None:
        p[nan_row, 1] = np.nan
    return p, t


LADDERS = [None, (64, 256, 1024), (3, 5, 100), (7,)]


@pytest.mark.parametrize("ladder", LADDERS)
def test_tiers_match_jax(ladder):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in list(range(1, 70)) + [255, 256, 257, 1023, 1025, 5000]:
            assert tpad.tier_for(n, ladder) == jpad.tier_for(n, ladder), n
        for max_rows in (1, 2, 3, 7, 8, 100, 1000, 1500):
            assert tpad.ladder_tiers(max_rows, ladder) == jpad.ladder_tiers(max_rows, ladder), max_rows
    for fn in (tpad.tier_for, jpad.tier_for, tpad.ladder_tiers, jpad.ladder_tiers):
        with pytest.raises(ValueError):
            fn(0, ladder)
    assert [tpad.next_pow2(n) for n in range(0, 20)] == [jpad.next_pow2(n) for n in range(0, 20)]


@pytest.mark.parametrize("raw", ["64,256,1024", " 8 , 2,2", "", "64,x", "0,8", "-4"])
def test_env_var_and_its_warn_once_fallbacks(monkeypatch, raw):
    monkeypatch.setenv("METRICS_TPU_PAD_LADDER", raw)
    for mod in (tpad, jpad):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = [mod.pad_ladder(), mod.pad_ladder(), mod.tier_for(3), mod.tier_for(2000), mod.tier_for(3000)]
        malformed = sum("malformed" in str(w.message) for w in rec)
        above = sum("exceeds the top padding tier" in str(w.message) for w in rec)
        if mod is tpad:
            ours, ours_warns = got, (malformed, above)
        else:
            assert ours == got and ours_warns == (malformed, above), (raw, ours, got, ours_warns, (malformed, above))
    assert ours_warns[0] == (1 if raw in ("64,x", "0,8", "-4") else 0)
    assert ours_warns[1] == (1 if raw in ("64,256,1024", " 8 , 2,2") else 0)


def test_leading_rows_skips_slice_rings():
    tree = {"sl__tp": torch.zeros(7, 3), "win__sl__x": torch.zeros(9), "preds": torch.zeros(16, 3)}
    jtree = {k: jnp.zeros(tuple(v.shape)) for k, v in tree.items()}
    assert tpad.leading_rows(tree) == jpad.leading_rows(jtree) == 16
    assert tpad.leading_rows((torch.zeros(()), [torch.zeros(5, 2)])) == jpad.leading_rows((jnp.zeros(()), [jnp.zeros((5, 2))])) == 5
    assert tpad.leading_rows({"sl__a": torch.zeros(3)}) is None is jpad.leading_rows({"sl__a": jnp.zeros(3)})


@pytest.mark.parametrize("n,valid", [(5, None), (8, None), (11, [True, False] * 5 + [True])])
def test_pad_rows_match_jax(n, valid):
    p, t = _rows(n)
    ours, omask = tpad.pad_rows((torch.from_numpy(p), torch.from_numpy(t)), valid=valid)
    ref, rmask = jpad.pad_rows((p, t), valid=valid)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(omask.numpy(), np.asarray(rmask))
    # numpy arrays pad on the host, as in the JAX package
    host, hmask = tpad.pad_rows((p, t), valid=valid)
    for a, b in zip(host, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(hmask.numpy(), np.asarray(rmask))
    with pytest.raises(ValueError, match="row-aligned"):
        tpad.pad_rows((torch.zeros(3), torch.zeros(4)))


def test_pad_update_args_match_jax_and_refuse_what_cannot_mask():
    p, t = _rows(6)
    tm = mtt.Accuracy(num_classes=C, device="cpu")
    jm = mt.Accuracy(num_classes=C)
    a, k, n_pad = tpad.pad_update_args(tm, (torch.from_numpy(p), torch.from_numpy(t)), {})
    ja, jk, jn = jpad.pad_update_args(jm, (p, t), {})
    assert n_pad == jn == 2
    for x, y in zip(a, ja):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(k["valid"].numpy(), np.asarray(jk["valid"]))
    # a caller's mask is and-ed in; a row-less call passes through
    a, k, _ = tpad.pad_update_args(tm, (torch.from_numpy(p),), {"valid": torch.tensor([1, 0, 1, 1, 1, 1], dtype=torch.bool)})
    assert k["valid"].tolist() == [True, False, True, True, True, True, False, False]
    assert tpad.pad_update_args(tm, (3.0,), {}) == ((3.0,), {}, 0)
    for pkg, err, mod, kw in ((mtt, MetricsTPUUserError, tpad, {"device": "cpu"}), (mt, JaxUserError, jpad, {})):
        for metric in (pkg.MeanSquaredError(**kw), pkg.AUROC(**kw)):
            assert not mod.supports_row_mask(metric)
            with pytest.raises(err, match="cannot consume a `valid` row mask"):
                mod.pad_update_args(metric, (np.zeros(3, np.float32), np.zeros(3, np.float32)), {})
    for pkg, err, kw in ((mtt, MetricsTPUUserError, {"device": "cpu"}), (mt, JaxUserError, {})):
        m = pkg.MeanSquaredError(pad_batches=True, **kw)
        with pytest.raises(err, match="cannot consume"):
            m.update(np.zeros(3, np.float32), np.zeros(3, np.float32))


def _metric_cases():
    return [
        ("acc", lambda pkg, **kw: pkg.Accuracy(num_classes=C, **kw)),
        ("prec_drop", lambda pkg, **kw: pkg.Precision(num_classes=C, average="macro", on_invalid="drop", **kw)),
        ("auroc_ring", lambda pkg, **kw: pkg.AUROC(num_classes=C, capacity=64, **kw)),
        ("windowed", lambda pkg, **kw: pkg.WindowedMetric(pkg.Accuracy(num_classes=C, **kw), window=16, buckets=2, **kw)),
    ]


@pytest.mark.parametrize("name,factory", _metric_cases(), ids=[c[0] for c in _metric_cases()])
def test_pad_batches_states_equal_the_unpadded_run_and_jax(name, factory):
    sizes = (5, 8, 3, 13)
    padded = factory(mtt, device="cpu", pad_batches=True) if name != "windowed" else mtt.WindowedMetric(
        mtt.Accuracy(num_classes=C, device="cpu"), window=16, buckets=2, pad_batches=True)
    plain = factory(mtt, device="cpu")
    ref = factory(mt, pad_batches=True) if name != "windowed" else mt.WindowedMetric(
        mt.Accuracy(num_classes=C), window=16, buckets=2, pad_batches=True)
    pads = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, n in enumerate(sizes):
            p, t = _rows(n, seed=i, nan_row=1 if name == "prec_drop" else None)
            if name == "auroc_ring":
                t = (t == 0).astype(np.int64)
                p = p / p.sum(axis=1, keepdims=True)
            padded.update(torch.from_numpy(p), torch.from_numpy(t))
            plain.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))
            pads += tpad.next_pow2(n) - n
    assert padded.fault_counts["padded_rows"] == pads == int(np.asarray(ref.metric_state["_faults"].counts)[6])
    ours = padded.metric_state
    want = {k: v for k, v in ours.items() if k != "_faults"}
    if name != "windowed" and name != "prec_drop":
        assert_states_close(want, plain.metric_state)
    if name == "windowed":
        # the window counts real rows only: the pad rows age nothing
        assert int(padded.window_rows) == int(plain.window_rows)
        assert float(padded.compute()) == float(plain.compute())
    assert_states_close(ours, dict(ref.metric_state))
    np.testing.assert_allclose(np.asarray(padded.compute()), np.asarray(ref.compute()), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# one row-mask predicate: the drop guard, can_drop_traced and the ladder
# ----------------------------------------------------------------------


def test_the_row_mask_predicate_matches_jax():
    cases = [
        lambda pkg, **kw: pkg.Accuracy(num_classes=3, **kw),
        lambda pkg, **kw: pkg.AUROC(**kw),
        lambda pkg, **kw: pkg.AUROC(capacity=8, **kw),
        lambda pkg, **kw: pkg.MeanSquaredError(**kw),
        lambda pkg, **kw: pkg.WindowedMetric(pkg.Accuracy(num_classes=3, **kw), window=8, buckets=2, **kw),
        lambda pkg, **kw: pkg.WindowedMetric(pkg.MeanSquaredError(**kw), window=8, buckets=2, **kw),
        lambda pkg, **kw: pkg.DecayedMetric(pkg.Precision(num_classes=3, **kw), halflife=4.0, **kw),
        lambda pkg, **kw: pkg.SlicedMetric(pkg.MeanSquaredError(**kw), num_slices=3, **kw),
    ]
    for case in cases:
        ours, ref = case(mtt, device="cpu"), case(mt)
        assert _consumes_valid_mask(ours) == jax_consumes(ref), type(ours).__name__
        assert tpad.supports_row_mask(ours) == jpad.supports_row_mask(ref) == _consumes_valid_mask(ours)
    w = mtt.WindowedMetric(mtt.Accuracy(num_classes=3, device="cpu"), window=8, buckets=2, device="cpu")
    assert _consumes_valid_mask(w) and can_drop_traced(w)


def test_guarded_drop_of_a_windowed_accuracy_reads_nothing_back():
    rng = np.random.default_rng(4)
    ours = mtt.WindowedMetric(mtt.Accuracy(num_classes=3, device="cpu"), window=8, buckets=2, on_invalid="drop", device="cpu")
    ref = mt.WindowedMetric(mt.Accuracy(num_classes=3), window=8, buckets=2, on_invalid="drop")
    values = []
    for i in range(4):
        p = rng.random((4, 3)).astype(np.float32)
        t = rng.integers(0, 3, 4)
        if i == 1:
            p[2, 0] = np.nan
        tp, tt = torch.from_numpy(p), torch.from_numpy(t)
        if i == 0:
            ours.update(tp, tt)  # the mode is resolved at the first update
        else:
            with _no_readback():
                ours.update(tp, tt)
        ref.update(jnp.asarray(p), jnp.asarray(t))
        values.append((float(ours.compute()), float(ref.compute())))
        assert_states_close(ours.metric_state, dict(ref.metric_state))
    assert all(a == b for a, b in values), values
    assert ours.fault_counts["dropped_rows"] == 1 == ours.fault_counts["nonfinite_preds"]
