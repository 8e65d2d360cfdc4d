"""The port's ``MetricCollection`` against the JAX one, and ``interop``
carrying a JAX collection's state into the port mid-stream.

The collection is the ImageNet evaluation set (top-1 and top-5 accuracy,
binned average precision) at C = 10 classes and T = 11 thresholds. Tolerances
as in ``test_torch_classification.py``: states and accuracy exact, average
precision ``atol=1e-6`` (float32 sums over thresholds in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402

C, T = 10, 11
BATCHES = (16, 16, 7)  # the last batch is ragged
AP_ATOL = 1e-6


def _eval_members(pkg, **kw):
    return {
        "acc1": pkg.Accuracy(num_classes=C, **kw),
        "acc5": pkg.Accuracy(num_classes=C, top_k=5, **kw),
        "bap": pkg.BinnedAveragePrecision(num_classes=C, thresholds=T, **kw),
    }


def _grouped_members(pkg, **kw):
    """Two pairs whose states are equal, so they form two compute groups."""
    return {
        "acc": pkg.Accuracy(num_classes=C, **kw),
        "ss": pkg.StatScores(reduce="micro", **kw),
        "bap": pkg.BinnedAveragePrecision(num_classes=C, thresholds=T, **kw),
        "brp": pkg.BinnedRecallAtFixedPrecision(num_classes=C, thresholds=T, min_precision=0.2, **kw),
    }


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in BATCHES:
        target = rng.integers(0, C, n)
        logits = rng.normal(size=(n, C)).astype(np.float32)
        logits[np.arange(n), target] += 1.5  # a planted signal: accuracy above chance
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        out.append((probs.astype(np.float32), target))
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_values(ours, ref):
    assert set(ours) == set(ref)
    for k, r in ref.items():
        if isinstance(r, list):
            np.testing.assert_allclose(np.stack([_np(v) for v in ours[k]]), np.stack([_np(v) for v in r]), rtol=0, atol=AP_ATOL)
        else:
            np.testing.assert_array_equal(_np(ours[k]), _np(r))


def _assert_states(ours, ref):
    for name in ref.keys(keep_base=True):
        r_state = ref.__getitem__(name, copy_state=False).metric_state
        o_state = ours.__getitem__(name, copy_state=False).metric_state
        assert set(o_state) == set(r_state)
        for k, v in r_state.items():
            assert _np(o_state[k]).dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(_np(o_state[k]), np.asarray(v))


@pytest.mark.parametrize("ops", [("update", "update", "update"), ("forward", "update", "forward"), ("update", "forward", "update")])
@pytest.mark.parametrize("members", [_eval_members, _grouped_members])
def test_collection_matches_jax(members, ops):
    ours = mtt.MetricCollection(members(mtt, device="cpu"))
    ref = mt.MetricCollection(members(mt))
    for op, (preds, target) in zip(ops, _batches()):
        if op == "update":
            ours.update(torch.from_numpy(preds), torch.from_numpy(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        else:
            _assert_values(ours(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
        _assert_states(ours, ref)
        assert ours.compute_groups == ref.compute_groups
    _assert_values(ours.compute(), ref.compute())


def test_compute_groups_form_as_in_jax():
    ours = mtt.MetricCollection(_grouped_members(mtt, device="cpu"))
    ref = mt.MetricCollection(_grouped_members(mt))
    preds, target = _batches()[0]
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert ours.compute_groups == ref.compute_groups == {0: ["acc", "ss"], 1: ["bap", "brp"]}
    # group members read their head's state: only heads update from now on
    preds, target = _batches()[1]
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ss = ours.__getitem__("ss", copy_state=False)
    acc = ours.__getitem__("acc", copy_state=False)
    assert ss.update_count == acc.update_count == 2
    for k in ("tp", "fp", "tn", "fn"):
        assert torch.equal(ss.metric_state[k], acc.metric_state[k])


def test_handed_out_members_are_copies():
    ours = mtt.MetricCollection(_grouped_members(mtt, device="cpu"))
    for preds, target in _batches()[:2]:
        ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ss = ours["ss"]  # copy_state=True: a copy of the head's state
    ss.metric_state["tp"].add_(1000)
    assert int(ours.__getitem__("acc", copy_state=False).metric_state["tp"]) < 1000


def test_interop_carries_jax_collection_state_mid_stream():
    batches = _batches(seed=3)
    ref = mt.MetricCollection(_eval_members(mt))
    for preds, target in batches[:2]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    carried = {name: {k: np.asarray(v) for k, v in m.metric_state.items()} for name, m in ref.items(keep_base=True)}

    ours = mtt.MetricCollection(_eval_members(mtt, device="cpu"))
    load_jax_state(ours, carried)
    for name, sub in carried.items():
        for k, v in ours.__getitem__(name, copy_state=False).metric_state.items():
            assert _np(v).dtype == sub[k].dtype  # dtypes kept: int32 counters, float32 bins
    preds, target = batches[2]
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_values(ours.compute(), ref.compute())


@pytest.mark.parametrize("name", ["acc1", "acc5", "bap"])
def test_interop_bare_metric(name):
    batches = _batches(seed=5)
    ref = _eval_members(mt)[name]
    ours = _eval_members(mtt, device="cpu")[name]
    ref.update(jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    load_jax_state(ours, {k: np.asarray(v) for k, v in ref.metric_state.items()})
    for preds, target in batches[1:]:
        ours.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_values({name: ours.compute()}, {name: ref.compute()})


def test_interop_refuses_foreign_state():
    ours = mtt.Accuracy(num_classes=C, device="cpu")
    with pytest.raises(ValueError, match="_faults"):
        load_jax_state(ours, {"tp": np.zeros((), np.int32), "_faults": np.zeros(4, np.uint32)})
    coll = mtt.MetricCollection(_eval_members(mtt, device="cpu"))
    with pytest.raises(ValueError, match="no member"):
        load_jax_state(coll, {"top1": {}})
    with pytest.raises(ValueError, match="shape"):
        load_jax_state(ours, {"tp": np.zeros((3,), np.int32)})


def test_collection_state_dict_round_trip_and_clone():
    coll = mtt.MetricCollection(_eval_members(mtt, device="cpu"))
    coll.persistent(True)
    for preds, target in _batches()[:2]:
        coll.update(torch.from_numpy(preds), torch.from_numpy(target))
    twin = coll.clone(prefix="val_")
    assert list(twin.keys()) == ["val_acc1", "val_acc5", "val_bap"]
    fresh = mtt.MetricCollection(_eval_members(mtt, device="cpu"))
    fresh.load_state_dict(coll.state_dict())
    preds, target = _batches()[2]
    for c in (coll, twin, fresh):
        c.update(torch.from_numpy(preds), torch.from_numpy(target))
    want = coll.compute()
    for c in (twin, fresh):
        got = {k.replace("val_", ""): v for k, v in c.compute().items()}
        _assert_values(got, want)
    coll.reset()
    assert all(int(m.update_count) == 0 for m in coll.values())
