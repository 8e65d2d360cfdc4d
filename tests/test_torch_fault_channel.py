"""The port's fault channel (``metrics_tpu_torch/utilities/guard.py`` and
``Metric(on_invalid=...)``) against the JAX package, on the inputs of
``tests/helpers/fault_injection.py``.

- The validators give the JAX package's masks, and the counts are
  bit-equal to its ``FaultCounters`` (int64 here, uint32 there) under every
  policy, after every update and forward.
- ``drop`` leaves the same states as JAX; ``warn`` warns once per new fault
  total, and ``error`` raises until ``reset``, both at ``compute()``.
- D1: a guarded update skips the value checks and reads nothing back,
  where the unguarded port raises; JAX's compiled update skips them too.

Values within ``ATOL`` (float32 ratios and sums in another order), states
and counts exact.
"""
import contextlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.utilities import guard as jguard  # noqa: E402
from metrics_tpu_torch.utilities import guard as tguard  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402
from tests.helpers.fault_injection import (  # noqa: E402
    corrupt_labels_out_of_range,
    corrupt_probs_out_of_range,
    corrupt_rows_nonfinite,
    pick_rows,
)

ATOL = 1e-6
C = 4
N = 32


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_counts(m):
    fc = m._state["_faults"]
    return {k: int(v) for k, v in fc.as_dict().items()}


def _faulty_batch(seed, n=N, kinds=("nan", "label")):
    """Multiclass probabilities with NaN/inf rows and out-of-range labels."""
    rng = np.random.default_rng(seed)
    p = rng.random((n, C)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t = rng.integers(0, C, n)
    rows = pick_rows(rng, n, 0.2)
    half = len(rows) // 2
    if "nan" in kinds:
        p = corrupt_rows_nonfinite(p, rows[:half], "nan")
    if "inf" in kinds:
        p = corrupt_rows_nonfinite(p, rows[half:half + 1], "inf")
    if "label" in kinds:
        t = corrupt_labels_out_of_range(t, rows[half + 1:], C, negative=bool(seed % 2))
    return p, t


def _values_close(ours, ref):
    if isinstance(ref, (list, tuple)):
        for o, r in zip(ours, ref):
            _values_close(o, r)
        return
    np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=0, atol=ATOL)


def _states_equal(ours, ref):
    for k, r in ref.metric_state.items():
        o = ours.metric_state[k]
        if k == "_faults":
            continue
        leaves = list(zip(o, r)) if isinstance(r, (list, tuple)) else [(o, r)]
        for oi, ri in leaves:
            np.testing.assert_array_equal(_np(oi), np.asarray(ri))


# ----------------------------------------------------------------------
# validators
# ----------------------------------------------------------------------


@pytest.mark.parametrize("nan_only", [False, True])
def test_validators_match_jax(nan_only):
    p, t = _faulty_batch(0, kinds=("nan", "inf", "label"))
    p = corrupt_probs_out_of_range(p, np.array([1, 2]))
    for fn, args in (
        ("nonfinite_rows", (p,)),
        ("prob_out_of_range_rows", (p,)),
        ("label_out_of_range_rows", (t, C)),
        ("label_out_of_range_rows", (t, C, 1)),
    ):
        kw = {"nan_only": nan_only} if fn == "nonfinite_rows" else {}
        ours = getattr(tguard, fn)(torch.from_numpy(args[0]), *args[1:], **kw)
        ref = getattr(jguard, fn)(jnp.asarray(args[0]), *args[1:], **kw)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ours, our_bad = tguard.batch_fault_masks(
        torch.from_numpy(p), torch.from_numpy(t), num_classes=C, check_probs=True, nan_only=nan_only
    )
    ref, ref_bad = jguard.batch_fault_masks(jnp.asarray(p), jnp.asarray(t), num_classes=C, check_probs=True, nan_only=nan_only)
    assert ours.counts.dtype == torch.int64
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts).astype(np.int64))
    np.testing.assert_array_equal(our_bad.numpy(), np.asarray(ref_bad))
    assert tguard.FAULT_CLASSES == jguard.FAULT_CLASSES
    assert tguard.actionable_fault_total(ours.counts) == jguard.actionable_fault_total(ref.counts)


def test_counters_add_and_count_past_uint32():
    """int64 carriage: past 2^32 the port keeps counting where JAX wraps
    (W2); below it both agree."""
    big = tguard.FaultCounters.single(dropped_rows=2**32 - 1) + tguard.FaultCounters.single(dropped_rows=2)
    assert big.as_dict()["dropped_rows"] == 2**32 + 1
    assert sum([tguard.FaultCounters.single(nonfinite_preds=1)] * 3).as_dict()["nonfinite_preds"] == 3


# ----------------------------------------------------------------------
# policies against JAX
# ----------------------------------------------------------------------


def _twins(name, policy, **kw):
    return getattr(mtt, name)(device="cpu", on_invalid=policy, **kw), getattr(mt, name)(on_invalid=policy, **kw)


GUARDED = [
    ("Accuracy", dict(num_classes=C)),
    ("Precision", dict(num_classes=C, average="macro")),
    ("F1Score", dict(num_classes=C, average="weighted")),
    ("StatScores", dict(reduce="samples")),  # refuses `valid`: drop indexes rows
    ("BinnedAveragePrecision", dict(num_classes=C, thresholds=11)),  # no `valid`: drop indexes rows
]


@pytest.mark.parametrize("policy", ["warn", "error", "drop"])
@pytest.mark.parametrize(("name", "kw"), GUARDED, ids=[n for n, _ in GUARDED])
def test_counts_and_states_match_jax(name, kw, policy):
    ours, ref = _twins(name, policy, **kw)
    for i, op in enumerate(("update", "forward", "update")):
        p, t = _faulty_batch(i + 1)
        if name == "StatScores":  # multilabel rows (NaN rows kept) for the per-sample reduction
            t = np.broadcast_to(t[:, None] % 2, (N, C))
        args_t, args_j = (torch.from_numpy(np.ascontiguousarray(p)), torch.from_numpy(np.ascontiguousarray(t))), (jnp.asarray(p), jnp.asarray(t))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if op == "update":
                ours.update(*args_t)
                ref.update(*args_j)
            elif policy == "error":
                with pytest.raises(MetricsTPUUserError):
                    ours(*args_t)
                with pytest.raises(Exception):
                    ref(*args_j)
            else:
                _values_close(ours(*args_t), ref(*args_j))
        assert ours.fault_counts == _jax_counts(ref), op
        _states_equal(ours, ref)
    if policy == "error":
        with pytest.raises(MetricsTPUUserError, match="nonfinite_preds") as err:
            ours.compute()
        with pytest.raises(Exception) as ref_err:
            ref.compute()
        assert str(err.value).split("(")[1].split(")")[0] == str(ref_err.value).split("(")[1].split(")")[0]
        return
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        value = ours.compute()
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        ref_value = ref.compute()
    _values_close(value, ref_value)
    warned = [w for w in got if "faults detected" in str(w.message)]
    assert len(warned) == len([w for w in want if "faults detected" in str(w.message)]) == (policy == "warn")


def test_drop_leaves_the_clean_stream_states():
    """``drop`` through ``valid``: the states are those of the stream with
    the faulty rows removed, on both packages."""
    p, t = _faulty_batch(5)
    bad = np.isnan(p).any(1) | (t < 0) | (t >= C)
    ours, ref = _twins("Accuracy", "drop", num_classes=C, average="macro")
    clean = mtt.Accuracy(num_classes=C, average="macro", device="cpu")
    ours.update(torch.from_numpy(p), torch.from_numpy(t))
    ref.update(jnp.asarray(p), jnp.asarray(t))
    clean.update(torch.from_numpy(p[~bad]), torch.from_numpy(t[~bad]))
    for k in ("tp", "fp", "tn", "fn"):
        assert torch.equal(ours.metric_state[k], clean.metric_state[k])
        np.testing.assert_array_equal(ours.metric_state[k].numpy(), np.asarray(ref.metric_state[k]))
    assert ours.fault_counts["dropped_rows"] == int(bad.sum()) == _jax_counts(ref)["dropped_rows"]


def test_warn_fires_once_per_new_total_and_error_until_reset():
    m = mtt.Accuracy(num_classes=3, on_invalid="warn", device="cpu")
    m.update(torch.tensor([[0.8, 0.1, 0.1]]), torch.tensor([7]))
    with pytest.warns(UserWarning, match="label_out_of_range=1"):
        m.compute()
    m._computed = None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.compute()  # the same total: no second warning
    m.update(torch.tensor([[0.8, 0.1, 0.1]]), torch.tensor([-1]))
    with pytest.warns(UserWarning, match="label_out_of_range=2"):
        m.compute()
    m.reset()
    m.update(torch.tensor([[0.8, 0.1, 0.1]]), torch.tensor([9]))
    with pytest.warns(UserWarning, match="label_out_of_range=1"):
        m.compute()  # the watermark restarted with the state

    e = mtt.MeanMetric(nan_strategy="warn", on_invalid="error", device="cpu")
    e.update(torch.tensor([1.0, float("nan")]))
    for _ in range(2):
        with pytest.raises(MetricsTPUUserError, match="nonfinite_preds=1"):
            e.compute()
    e.reset()
    e.update(torch.tensor([1.0, 3.0]))
    assert float(e.compute()) == 2.0


def test_error_in_forward_keeps_the_accumulated_stream():
    m = mtt.SumMetric(nan_strategy="warn", on_invalid="error", device="cpu")
    m.update(torch.tensor([1.0, 2.0]))
    with pytest.raises(MetricsTPUUserError):
        m(torch.tensor([float("nan"), 4.0]))
    assert float(m.value) == 7.0 and m.fault_counts["nonfinite_preds"] == 1


def test_nonfinite_state_found_at_compute():
    class Raw(mtt.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("v", torch.tensor(0.0), "sum")

        def update(self, x):
            self.v = self.v + x.sum()

        def compute(self):
            return self.v

    m = Raw(on_invalid="warn", device="cpu")
    m.update(torch.tensor([float("inf"), float("-inf")]))  # inf - inf: a NaN state
    with pytest.warns(UserWarning, match="nonfinite_state=1"):
        m.compute()


def test_probability_range_is_opt_in():
    p, t = torch.tensor([0.2, 1.7, 0.9]), torch.tensor([0, 1, 1])
    m = mtt.Accuracy(on_invalid="warn", device="cpu")
    m.update(p, t)
    assert m.fault_counts["prob_out_of_range"] == 0
    m2 = mtt.Accuracy(on_invalid="warn", device="cpu")
    m2._guard_probs = True
    m2.update(p, t)
    ref = mt.Accuracy(on_invalid="warn")
    ref._guard_probs = True
    ref.update(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()))
    assert m2.fault_counts == _jax_counts(ref) and m2.fault_counts["prob_out_of_range"] == 1


def test_faults_merge_in_forward_and_round_trip_state_dict():
    m = mtt.MeanMetric(device="cpu")  # nan_strategy="warn" guards by default
    m(torch.tensor([1.0, float("nan")]))
    m.update(torch.tensor([float("nan"), 3.0]))
    assert m.fault_counts["nonfinite_preds"] == 2 == m.fault_counts["dropped_rows"]
    m.persistent(True)
    sd = m.state_dict()
    assert sd["_faults"].dtype == torch.int64 and sd["_faults"].shape == (tguard.NUM_FAULT_CLASSES,)
    fresh = mtt.MeanMetric(device="cpu")
    fresh.load_state_dict(sd)
    assert fresh.fault_counts == m.fault_counts
    fresh.load_state_dict({"_faults": np.array([1, 2, 3], np.uint32)})  # an older, shorter vector
    assert list(fresh.fault_counts.values()) == [1, 2, 3, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="FaultCounters"):
        fresh.load_state_dict({"_faults": np.array([-1.5])})


# ----------------------------------------------------------------------
# D1: the guarded update skips the value checks and reads nothing back
# ----------------------------------------------------------------------


@contextlib.contextmanager
def _no_readback():
    """Any read of a tensor's value back to the host raises inside."""
    names = ("item", "tolist", "__bool__", "__int__", "__float__", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was read back to the host")

    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


def test_d1_value_checks_against_jax():
    from metrics_tpu_torch._capture import UpdateGraphs

    preds = np.array([[0.2, 0.5, 0.3], [0.6, 0.3, 0.1]], np.float32)
    target = np.array([0, 3])
    # unguarded and eager (the CPU): the port checks the label and raises;
    # JAX's compiled update does not
    with pytest.raises(ValueError, match="highest label"):
        mtt.Accuracy(num_classes=3, device="cpu").update(torch.from_numpy(preds), torch.from_numpy(target))
    mt.Accuracy(num_classes=3).update(jnp.asarray(preds), jnp.asarray(target))
    # unguarded and captured (the card; here a stand-in capture step that
    # replays the body eagerly): the first update at a key is eager and
    # checks, a replay does not, as JAX's jitted update never does
    good = np.array([0, 2])
    captured = mtt.Accuracy(num_classes=3, device="cpu")
    object.__setattr__(captured, "_update_graphs", UpdateGraphs(capture=lambda run, pool: run))
    for y in (good, good, target):
        captured.update(torch.from_numpy(preds), torch.from_numpy(y))
    jm = mt.Accuracy(num_classes=3)
    for y in (good, good, target):
        jm.update(jnp.asarray(preds), jnp.asarray(y))
    assert captured.__dict__["_update_graphs"].replays == 2
    assert float(captured.compute()) == float(jm.compute())
    for policy in ("warn", "drop"):
        ours, ref = _twins("Accuracy", policy, num_classes=3)
        tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
        ours.update(tp, tt)  # the mode is resolved at the first update
        with _no_readback():
            ours.update(tp, tt)
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        assert ours.fault_counts == _jax_counts(ref) and ours.fault_counts["label_out_of_range"] == 2
        _states_equal(ours, ref)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _values_close(ours.compute(), ref.compute())


def test_guarded_sketch_and_aggregator_updates_read_nothing_back():
    x = torch.tensor([1.0, float("nan"), float("inf"), 2.0])
    q = mtt.QuantileSketch(on_invalid="drop", quantiles=(0.5,), device="cpu")
    mean = mtt.MeanMetric(nan_strategy="warn", device="cpu")
    cm = mtt.CountMinSketch(width=64, on_invalid="warn", device="cpu")
    with _no_readback():
        q.update(x)
        mean.update(x)
        cm.update(x)
    ref_q = mt.QuantileSketch(on_invalid="drop", quantiles=(0.5,))
    ref_q.update(jnp.asarray(x.numpy()))
    ref_mean = mt.MeanMetric(nan_strategy="warn")
    ref_mean.update(jnp.asarray(x.numpy()))
    assert q.fault_counts == _jax_counts(ref_q)
    assert mean.fault_counts == _jax_counts(ref_mean)
    assert q.fault_counts["dropped_rows"] == 2 and mean.fault_counts["dropped_rows"] == 1
