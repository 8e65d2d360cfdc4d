"""The rest of the port's ``Metric`` runtime against the JAX package:
metric arithmetic (``CompositionalMetric`` and every operator overload),
the identity hash, casting, and the constructor knobs ``compute_on_cpu``,
``dist_sync_on_step`` and ``sync_on_compute``; and a composition inside a
``MetricCollection`` synced across four Gloo processes.

Values computed from counts are held to ``SUM_ATOL`` (float32 sums over
classes in another order, stated difference D2); counts are exact.

D22: a metric hashes by identity (``==`` builds a composition), where the
JAX package hashes the ids of its state arrays, which an update replaces.
D23: inside a collection a composition's operands ride the collection's one
sync (one ``all_reduce`` per bucket for the whole collection, every rank
issuing the same collectives); outside one, each operand syncs at its own
``compute()``, as in JAX.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.metric as jax_metric_mod  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.metric as metric_mod  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402
from tests.helpers import torch_classification_ranks as R  # noqa: E402
from tests.helpers.torch_twin_world import TwinWorld  # noqa: E402
from tests.test_torch_classification import _np  # noqa: E402

SUM_ATOL = 1e-6

C = 4
N = 30


def _batch(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(0, C, n), rng.integers(0, C, n)


def _pair(pkg, dev):
    return pkg.Precision(num_classes=C, average="macro", **dev), pkg.Recall(num_classes=C, average="macro", **dev)


def _close(ours, ref, atol=SUM_ATOL):
    o, r = _np(ours), np.asarray(ref)
    assert o.shape == r.shape, (o.shape, r.shape)
    np.testing.assert_allclose(o.astype(np.float64), r.astype(np.float64), rtol=0, atol=atol)


OPS = {
    "add": lambda a, b: a + b,
    "radd": lambda a, b: 2 + a,
    "sub": lambda a, b: a - b,
    "rsub": lambda a, b: 1 - a,
    "mul": lambda a, b: a * b,
    "rmul": lambda a, b: 3 * a,
    "truediv": lambda a, b: a / b,
    "rtruediv": lambda a, b: 1 / a,
    "floordiv": lambda a, b: (a * 10) // b,
    "rfloordiv": lambda a, b: 5 // (a + 1),
    "mod": lambda a, b: (a * 10) % 3,
    "rmod": lambda a, b: 2 % (a + 1),
    "pow": lambda a, b: a**2,
    "rpow": lambda a, b: 2**a,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "ge": lambda a, b: a >= b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "lt": lambda a, b: a < b,
    "abs": lambda a, b: abs(a - 1),
    "neg": lambda a, b: -a,
    "pos": lambda a, b: +(a - 1),
    "f1": lambda a, b: 2 * a * b / (a + b),
}


@pytest.mark.parametrize("op", list(OPS))
def test_operator_overloads_match_jax(op):
    ours = OPS[op](*_pair(mtt, {"device": "cpu"}))
    ref = OPS[op](*_pair(mt, {}))
    assert isinstance(ours, mtt.CompositionalMetric)
    for seed, kind in enumerate(("forward", "update", "forward")):
        preds, target = _batch(seed)
        if kind == "update":
            ours.update(torch.from_numpy(preds), torch.from_numpy(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        else:
            _close(ours(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
    _close(ours.compute(), ref.compute())
    ours.reset()
    ref.reset()
    assert not ours._update_called
    preds, target = _batch(9)
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    _close(ours.compute(), ref.compute())


@pytest.mark.parametrize("op", ["and", "or", "xor", "invert", "getitem", "matmul"])
def test_integer_and_indexing_overloads_match_jax(op):
    """Bitwise operators over integer values (a confusion matrix), indexing
    and a matrix product."""
    build = {
        "and": lambda a, b: a & b,
        "or": lambda a, b: a | b,
        "xor": lambda a, b: a ^ b,
        "invert": lambda a, b: ~a,
        "getitem": lambda a, b: a[1],
        "matmul": lambda a, b: a @ b,
    }[op]
    ours = build(mtt.ConfusionMatrix(C, device="cpu"), mtt.ConfusionMatrix(C, device="cpu"))
    ref = build(mt.ConfusionMatrix(C), mt.ConfusionMatrix(C))
    preds, target = _batch(3)
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_array_equal(_np(ours.compute()), np.asarray(ref.compute()))


def test_hash_is_identity_and_survives_reset():
    m = mtt.Accuracy(num_classes=C, device="cpu")
    h = hash(m)
    table = {m: "acc"}
    m.update(*(torch.from_numpy(x) for x in _batch(0)))
    m.reset()
    assert hash(m) == h and table[m] == "acc" and m in {m}
    other = mtt.Accuracy(num_classes=C, device="cpu")
    assert hash(other) != h
    assert isinstance(m == other, mtt.CompositionalMetric)  # a lazy comparison, not a bool
    # the JAX package hashes its state arrays' ids, which an update replaces
    ref = mt.Accuracy(num_classes=C)
    before = hash(ref)
    ref.update(*(jnp.asarray(x) for x in _batch(0)))
    assert hash(ref) != before


def test_set_dtype_and_the_no_op_casts_match_jax():
    ours, ref = mtt.MeanMetric(device="cpu"), mt.MeanMetric()
    assert ours.float() is ours and ours.double() is ours and ours.half() is ours and ours.type(torch.float64) is ours
    ours.set_dtype(torch.float64)
    ref.set_dtype(jnp.float16)
    x = np.array([1.5, 2.25, 3.0], np.float32)
    ours.update(torch.from_numpy(x))
    ref.update(jnp.asarray(x))
    assert ours.metric_state["value"].dtype == torch.float64 and ours._defaults["weight"].dtype == torch.float64
    _close(ours.compute(), ref.compute())
    ints = mtt.ConfusionMatrix(C, device="cpu").set_dtype(torch.float64)
    assert ints.metric_state["confmat"].dtype == torch.int32
    lists = mtt.CalibrationError(device="cpu").set_dtype(torch.float64)
    assert lists._sync_defaults()["confidences"].dtype == torch.float64


def test_compute_on_cpu_keeps_lists_on_the_host_and_matches_jax():
    ours = mtt.CalibrationError(n_bins=5, compute_on_cpu=True, device="cpu")
    ref = mt.CalibrationError(n_bins=5, compute_on_cpu=True)
    rng = np.random.default_rng(4)
    for _ in range(3):
        p, t = rng.random(N).astype(np.float32), rng.integers(0, 2, N)
        ours.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    assert all(x.device.type == "cpu" for x in ours._state["confidences"])
    value = ours.compute()
    assert value.device.type == "cpu"
    _close(value, ref.compute())
    assert ours.compute_on_cpu and ref.compute_on_cpu


def _jax_twin_gather(x, group=None):
    return [x, x]


def test_dist_sync_on_step_and_sync_on_compute_match_jax(monkeypatch):
    """In a fake two-rank world whose other rank holds this rank's state:
    ``dist_sync_on_step`` syncs forward's batch value (a sum doubles), and
    ``sync_on_compute=False`` computes the local value."""
    monkeypatch.setattr(metric_mod, "distributed_available", lambda: True)
    monkeypatch.setattr(jax_metric_mod, "distributed_available", lambda: True)
    x = np.array([1.0, 2.0, 4.0], np.float32)
    ours = mtt.SumMetric(dist_sync_on_step=True, dist_sync_fn=TwinWorld(), device="cpu")
    ref = mt.SumMetric(dist_sync_on_step=True, dist_sync_fn=_jax_twin_gather)
    for _ in range(2):
        batch = ours(torch.from_numpy(x))
        _close(batch, ref(jnp.asarray(x)))
        assert float(batch) == 14.0  # the batch's 7 on each of the two ranks
    _close(ours.compute(), ref.compute())
    assert float(ours.compute()) == 28.0  # 7 + 7 on each rank
    local = mtt.SumMetric(sync_on_compute=False, dist_sync_fn=TwinWorld(), device="cpu")
    local_ref = mt.SumMetric(sync_on_compute=False, dist_sync_fn=_jax_twin_gather)
    local.update(torch.from_numpy(x))
    local_ref.update(jnp.asarray(x))
    assert local.dist_sync_fn.calls == []
    _close(local.compute(), local_ref.compute())
    assert float(local.compute()) == 7.0 and local.dist_sync_fn.calls == []


def test_composition_reaches_its_operands_and_the_device():
    p, r = _pair(mtt, {"device": "cpu"})
    f1 = 2 * p * r / (p + r)
    assert f1.device == torch.device("cpu")
    assert [type(m).__name__ for m in f1.operand_leaves()] == ["Precision", "Recall"]
    f1.persistent(True)
    assert all(p._persistent.values()) and all(r._persistent.values())
    assert f1.metric_state == {}
    assert "truediv" in repr(f1)


def test_a_synced_metric_refuses_an_update():
    m = mtt.SumMetric(device="cpu")
    m._is_synced = True
    with pytest.raises(MetricsTPUUserError, match="unsync"):
        m.update(torch.ones(2))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    n = 4
    store = tmp_path_factory.mktemp("classification4") / "store"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=R.rank_main, args=(r, n, str(store), queue)) for r in range(n)]
    for proc in procs:
        proc.start()
    try:
        results = dict(queue.get(timeout=240) for _ in procs)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    for r, res in sorted(results.items()):
        if "error" in res:
            pytest.fail(f"rank {r} of {n} failed:\n{res['error']}")
    assert [proc.exitcode for proc in procs] == [0] * n
    return n, [results[r] for r in range(n)]


def test_collection_with_a_composition_syncs_in_one_all_reduce_per_bucket(world4):
    """Four Gloo ranks (one without rows): ``compute()`` makes one
    ``all_reduce`` per (reduction, dtype) bucket (int32 counts, float32
    calibration bins) and no gather, and every value equals one process over
    all the rows; the confusion matrix bit-equal."""
    n, results = world4
    for res in results:
        assert res["jax_loaded"] == []
        assert sorted(c[:2] for c in res["calls"]) == [("all_reduce", "float32"), ("all_reduce", "int32")], res["calls"]
    one = R.collection(mtt, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for rows in R.shards(n):
            R.feed(one, rows, torch)
        want = {k: _np(v) for k, v in one.compute().items()}
    for res in results:
        np.testing.assert_array_equal(res["values"]["cm"], want["cm"])
        for k in ("kappa", "f1", "ce"):
            np.testing.assert_allclose(res["values"][k], want[k], rtol=0, atol=SUM_ATOL)
    # the ranks' local states came back after the synced compute
    assert sum(int(res["local_cm"].sum()) for res in results) == sum(R.ROWS)


def test_the_four_rank_values_match_jax_over_the_stream(world4):
    n, results = world4
    ref = mt.MetricCollection({
        "cm": mt.ConfusionMatrix(R.C),
        "kappa": mt.CohenKappa(R.C),
        "f1": (lambda p, r: 2 * p * r / (p + r))(*(cls(num_classes=R.C, average="macro") for cls in (mt.Precision, mt.Recall))),
        "ce": mt.CalibrationError(n_bins=10, binned=True),
    })
    for probs, target in R.shards(n):
        if probs.shape[0]:
            ref.update(jnp.asarray(probs), jnp.asarray(target))
    want = ref.compute()
    np.testing.assert_array_equal(results[0]["values"]["cm"], np.asarray(want["cm"]))
    for k in ("kappa", "f1", "ce"):
        np.testing.assert_allclose(results[0]["values"][k], np.asarray(want[k]), rtol=0, atol=SUM_ATOL)
