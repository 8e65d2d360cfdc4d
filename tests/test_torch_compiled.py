"""The compiled update (``metrics_tpu_torch/_capture.py``, the counterpart of
``metrics_tpu/metric.py:394``) on the CPU, where nothing is captured: each
metric is given a graph table whose capture step records the call and hands
the body back, so a "replay" runs the captured body eagerly. The tests pin
the table's rules (one capture per key, none on a hit, the states'
identity across the W5 events, the copy-back of every state an update
rebinds, the fallback after a failed capture), ``debug_checks`` against
JAX's ``checkify`` and ``entry_points()``, and hold the captured metrics'
states and values against their eager twins and against JAX."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch._capture import UpdateGraphs, _value_leaves  # noqa: E402
from metrics_tpu_torch.ops import padding  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402
from tests.helpers.torch_twin_world import TwinWorld  # noqa: E402

C = 5


@pytest.fixture(autouse=True)
def _ladder(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_PAD_LADDER", "8,32")
    padding.reset_padding_state()
    yield
    padding.reset_padding_state()


class Recorder:
    """A capture step for the CPU: records each call and returns the body,
    which each replay then runs eagerly."""

    def __init__(self):
        self.calls = 0

    def __call__(self, run, pool):
        self.calls += 1
        return run


def captured(metric, recorder=None):
    """``metric`` (or each member of a collection) with a stand-in table."""
    recorder = recorder or Recorder()
    members = metric.items(keep_base=True, copy_state=False) if hasattr(metric, "_modules") else [("", metric)]
    for _, m in members:
        object.__setattr__(m, "_update_graphs", UpdateGraphs(capture=recorder))
    return metric


def table(m):
    return m.__dict__["_update_graphs"]


def leaves(m):
    return [t for v in m._state.values() for t in _value_leaves(v)]


def assert_same_states(a, b):
    assert a._state.keys() == b._state.keys()
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


def batch(rng, n, c=C):
    p = rng.random((n, c)).astype(np.float32)
    t = rng.integers(0, c, n)
    return torch.from_numpy(p), torch.from_numpy(t)


def guarded_acc(**kw):
    return mtt.Accuracy(num_classes=C, on_invalid="drop", pad_batches=True, device="cpu", **kw)


def test_one_capture_per_tier_and_none_on_a_hit():
    rng = np.random.default_rng(0)
    rec = Recorder()
    m, twin = captured(guarded_acc(), rec), guarded_acc()
    sizes = [3, 5, 7, 20, 8, 30, 2, 17, 6, 32]  # tiers 8 and 32
    for n in sizes:
        p, t = batch(rng, n)
        m.update(p, t)
        twin.update(p, t)
        assert_same_states(m, twin)
    tb = table(m)
    # per tier: the first update eager, the second captures, the rest replay
    assert rec.calls == tb.captures == 2
    assert tb.eager_updates == 2
    assert tb.replays == len(sizes) - 2
    assert torch.equal(m.compute(), twin.compute())


def test_key_holds_the_data_inferred_attributes():
    """A key is the arguments and the data-inferred attributes, as they
    stand after the first (eager) update at it."""
    rng = np.random.default_rng(1)
    rec = Recorder()
    m = captured(guarded_acc(), rec)
    for _ in range(3):
        m.update(*batch(rng, 8))
    assert rec.calls == 1
    key_attrs = {k[1] for k in table(m).entries}
    assert key_attrs == {(("mode", m.mode), ("subset_accuracy", False))}


def test_first_update_at_a_key_checks_values_and_replays_do_not():
    """D1 on the card: an unguarded update checks values at the first update
    of a key only, as JAX's jitted update never does; on the CPU (no table)
    it always checks."""
    rng = np.random.default_rng(2)
    m = captured(mtt.Accuracy(num_classes=C, device="cpu"))
    p, t = batch(rng, 6)
    bad = t.clone()
    bad[0] = C + 3
    with pytest.raises(ValueError):
        m.update(p, bad)  # the first update at this key: eager, checked
    m.update(p, t)
    m.update(p, t)  # captured
    m.update(p, bad)  # a replay: no check, as JAX's jit
    jm = mt.Accuracy(num_classes=C)
    for y in (t, t, bad):
        jm.update(jnp.asarray(p.numpy()), jnp.asarray(y.numpy()))
    assert float(m.compute()) == float(jm.compute())
    plain = mtt.Accuracy(num_classes=C, device="cpu")
    plain.update(p, t)
    with pytest.raises(ValueError):
        plain.update(p, bad)


def _out_of_place_cases():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=12).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=12).astype(np.float32))
    pos = torch.from_numpy(rng.random(12).astype(np.float32) + 0.1)
    p, t = batch(rng, 12)
    return {
        "guard faults": (lambda: mtt.Accuracy(num_classes=C, on_invalid="warn", device="cpu"), (p, t)),
        "mean aggregation": (lambda: mtt.MeanMetric(device="cpu"), (x,)),
        "sum aggregation": (lambda: mtt.SumMetric(device="cpu"), (x,)),
        "max aggregation": (lambda: mtt.MaxMetric(device="cpu"), (x,)),
        "r2": (lambda: mtt.R2Score(device="cpu"), (x, y)),
        "explained variance": (lambda: mtt.ExplainedVariance(device="cpu"), (x, y)),
        "tweedie deviance": (lambda: mtt.TweedieDevianceScore(power=1.5, device="cpu"), (pos, pos.flip(0))),
        "ring append": (lambda: mtt.AUROC(capacity=64, device="cpu"), (torch.sigmoid(x), (y > 0).to(torch.int64))),
        "retrieval ring append": (
            lambda: mtt.RetrievalMAP(capacity=64, num_queries=3, device="cpu"),
            (torch.sigmoid(x), (y > 0).to(torch.int64)),
            {"indexes": torch.arange(12) % 3},
        ),
    }


OUT_OF_PLACE = _out_of_place_cases()


@pytest.mark.parametrize("case", sorted(OUT_OF_PLACE))
def test_rebound_states_are_copied_back(case):
    """Every update that rebinds a state (``self.x = self.x + ...``, a ring's
    new ``dropped``) is followed, inside the captured body, by a copy into
    the tensor the graph was captured against: the identity holds across
    replays and the values equal the eager twin's."""
    make, args, *rest = OUT_OF_PLACE[case]
    kwargs = rest[0] if rest else {}
    m, twin = captured(make()), make()
    m.update(*args, **kwargs)
    twin.update(*args, **kwargs)
    bound = leaves(m)
    for _ in range(4):
        m.update(*args, **kwargs)
        twin.update(*args, **kwargs)
        assert all(a is b for a, b in zip(leaves(m), bound)), "a replay rebound a state"
        assert_same_states(m, twin)
    tb = table(m)
    assert (tb.captures, tb.replays, tb.dropped) == (1, 4, 0)
    assert m.jittable_update


def test_reset_and_load_drop_the_graphs():
    rng = np.random.default_rng(4)
    m, twin = captured(guarded_acc()), guarded_acc()
    data = [batch(rng, 8) for _ in range(3)]
    for p, t in data:
        m.update(p, t)
        twin.update(p, t)
    assert table(m).captures == 1
    m.reset()
    twin.reset()
    assert not table(m).entries  # new state tensors: the graphs go
    for p, t in data:
        m.update(p, t)
        twin.update(p, t)
    assert table(m).captures == 2
    assert_same_states(m, twin)
    saved = twin.state_dict()
    m.persistent(True)
    twin.persistent(True)
    m.load_state_dict(twin.state_dict())
    assert not table(m).entries
    for p, t in data:
        m.update(p, t)
        twin.update(p, t)
    assert_same_states(m, twin)
    assert saved is not None


def test_sync_and_unsync_keep_the_graphs(monkeypatch):
    rng = np.random.default_rng(5)
    m = captured(guarded_acc())
    for _ in range(3):
        m.update(*batch(rng, 8))
    before = leaves(m)
    m.sync(dist_sync_fn=TwinWorld(), distributed_available_fn=lambda: True)
    with pytest.raises(MetricsTPUUserError):
        m.update(*batch(rng, 8))
    m.unsync()
    assert all(a is b for a, b in zip(leaves(m), before))
    captures = table(m).captures
    m.update(*batch(rng, 8))
    assert table(m).captures == captures and table(m).dropped == 0


def test_forward_stays_eager_and_moves_the_key():
    """``forward`` runs its updates eagerly; its merge makes new state
    tensors, so the next update drops the graphs (a new key) and captures
    again; every value equals the eager twin's."""
    rng = np.random.default_rng(6)
    rec = Recorder()
    m, twin = captured(guarded_acc(), rec), guarded_acc()
    for i in range(9):
        p, t = batch(rng, 8)
        if i == 4:
            assert torch.equal(m(p, t), twin(p, t))
        else:
            m.update(p, t)
            twin.update(p, t)
        assert_same_states(m, twin)
    assert table(m).dropped == 1 and rec.calls == 2
    assert torch.equal(m.compute(), twin.compute())


def test_clone_and_deepcopy_start_without_graphs():
    rng = np.random.default_rng(7)
    m = captured(guarded_acc())
    for _ in range(3):
        m.update(*batch(rng, 8))
    for c in (m.clone(), copy.deepcopy(m)):
        assert "_update_graphs" not in c.__dict__
        assert_same_states(c, m)


def test_compute_group_shares_the_head_states_through_replays():
    """A compute group captures its head's update only; the members point at
    the head's tensors, which the replays (and the copy-back of the fault
    counters) write in place."""
    rng = np.random.default_rng(8)

    def coll():
        return mtt.MetricCollection({
            "prec": mtt.Precision(num_classes=C, average="macro", on_invalid="warn", device="cpu"),
            "rec": mtt.Recall(num_classes=C, average="macro", on_invalid="warn", device="cpu"),
        })

    a, b = captured(coll()), coll()
    for _ in range(5):
        p, t = batch(rng, 8)
        a.update(p, t)
        b.update(p, t)
    assert a.compute_groups == {0: ["prec", "rec"]}
    head, member = (m for _, m in a.items(keep_base=True, copy_state=False))
    assert all(x is y for x, y in zip(leaves(head), leaves(member)))
    assert table(head).replays == 4 and table(member).replays == 0
    va, vb = a.compute(), b.compute()
    for k in vb:
        assert torch.equal(va[k], vb[k])


def test_failed_capture_turns_jittable_update_off():
    """A capture that fails runs the update eagerly and sets
    ``jittable_update`` False on the instance, as JAX's runtime does after a
    failed trace; the states are those of the eager twin."""
    rng = np.random.default_rng(9)

    def refusing(run, pool):
        raise RuntimeError("operation not permitted when stream is capturing")

    m = mtt.Accuracy(num_classes=C, on_invalid="warn", device="cpu")
    object.__setattr__(m, "_update_graphs", UpdateGraphs(capture=refusing))
    twin = mtt.Accuracy(num_classes=C, on_invalid="warn", device="cpu")
    for _ in range(4):
        p, t = batch(rng, 8)
        m.update(p, t)
        twin.update(p, t)
        assert_same_states(m, twin)
    assert m.jittable_update is False and type(m).jittable_update is True
    assert "stream is capturing" in table(m).error
    assert table(m).captures == 0 and table(m).eager_updates == 2


def test_a_state_that_changes_shape_refuses_the_capture():
    class Growing(mtt.SumMetric):
        def update(self, value):
            self.value = torch.cat([self.value.reshape(-1), value.sum().reshape(1)])

    m = Growing(device="cpu")
    object.__setattr__(m, "_update_graphs", UpdateGraphs(capture=lambda run, pool: (run(), run)[1]))
    for _ in range(3):
        m.update(torch.ones(2))
    assert m.jittable_update is False
    assert "layout" in table(m).error


def test_launches_recorded_at_capture_are_added_at_each_replay(monkeypatch):
    """A replay runs no wrapper: the launches counted while capturing are
    taken back (the capture ran nothing) and added at every replay."""
    from metrics_tpu_torch.ops import _build, binned_counters

    def counting_capture(run, pool):
        _build.count_launch(binned_counters.__name__)  # what a kernel wrapper does while captured

        def replay():
            pass

        return replay

    binned_counters.reset_launch_count()
    m = mtt.MeanMetric(device="cpu")
    object.__setattr__(m, "_update_graphs", UpdateGraphs(capture=counting_capture))
    for _ in range(6):
        m.update(torch.ones(3))
    # updates 1 (eager) and 2 (capture, then its first replay), then 4 replays
    assert binned_counters.launch_count == 5
    binned_counters.reset_launch_count()


def test_debug_checks_raises_where_checkify_raises():
    """``debug_checks=True``: the update stays eager and a NaN made in the
    states raises, as JAX's ``checkify.float_checks`` does on the same
    input (D36: the port looks at the states, JAX at every operation; an
    infinity alone raises here only)."""
    from jax._src.checkify import JaxRuntimeError

    for cls, jcls in ((mtt.SumMetric, mt.SumMetric), (mtt.MeanMetric, mt.MeanMetric)):
        m, jm = cls(debug_checks=True, device="cpu"), jcls(debug_checks=True)
        m.update(torch.tensor([1.0, 2.0]))
        jm.update(jnp.asarray([1.0, 2.0]))
        assert "_update_graphs" not in m.__dict__
        with pytest.raises(JaxRuntimeError):
            jm.update(jnp.asarray([np.inf, -np.inf]))
        with pytest.raises(MetricsTPUUserError, match="NaN or an infinity"):
            m.update(torch.tensor([np.inf, -np.inf]))
        m2, jm2 = cls(debug_checks=True, device="cpu"), jcls(debug_checks=True)
        jm2.update(jnp.asarray([np.inf, 1.0]))
        with pytest.raises(MetricsTPUUserError):
            m2.update(torch.tensor([np.inf, 1.0]))


def test_debug_checks_is_never_captured():
    rng = np.random.default_rng(10)
    m = mtt.Accuracy(num_classes=C, debug_checks=True, device="cpu")
    assert m._update_graph_table() is None
    m.update(*batch(rng, 8))
    assert float(m.compute()) >= 0.0


def test_entry_points_have_jax_names():
    acc, jacc = mtt.Accuracy(num_classes=C, device="cpu"), mt.Accuracy(num_classes=C)
    assert list(mtt.functionalize(acc).entry_points()) == list(mt.functionalize(jacc).entry_points()) == ["update", "compute"]
    odef = mtt.overlapped_functionalize(mtt.Accuracy(num_classes=C, device="cpu"))
    jodef = mt.overlapped_functionalize(mt.Accuracy(num_classes=C), axis_name="data")
    assert list(odef.entry_points()) == list(jodef.entry_points()) == ["update", "cycle", "read", "read_fresh", "lag"]
    mdef = mtt.functionalize(acc)
    ep = mdef.entry_points()
    rng = np.random.default_rng(11)
    state = ep["update"](mdef.init(), *batch(rng, 8))
    assert float(ep["compute"](state)) >= 0.0


def test_captured_collection_matches_jax():
    """The slice as a whole on the CPU: the main path's collection, guarded
    and padded (BAP guarded by ``"warn"``: it takes no row mask), captured,
    over ragged batches beside the JAX collection on the same numpy inputs."""
    rng = np.random.default_rng(12)

    def coll(pkg, **dev):
        return pkg.MetricCollection({
            "acc1": pkg.Accuracy(num_classes=C, on_invalid="drop", pad_batches=True, **dev),
            "acc5": pkg.Accuracy(num_classes=C, top_k=2, on_invalid="drop", pad_batches=True, **dev),
            "bap": pkg.BinnedAveragePrecision(num_classes=C, thresholds=10, on_invalid="warn", **dev),
        })

    a, j = captured(coll(mtt, device="cpu")), coll(mt)
    for n in (8, 8, 8, 30, 32, 7, 8, 8):
        p = rng.random((n, C)).astype(np.float32)
        p[0, 1] = np.nan  # a fault row, dropped by the accuracies, counted by BAP's guard
        t = rng.integers(0, C, n)
        a.update(torch.from_numpy(p), torch.from_numpy(t))
        j.update(jnp.asarray(p), jnp.asarray(t))
    va, vj = a.compute(), j.compute()
    for k in ("acc1", "acc5"):
        assert float(va[k]) == float(vj[k])
    np.testing.assert_allclose(np.asarray([float(v) for v in va["bap"]]), np.asarray([float(v) for v in vj["bap"]]), atol=1e-6)
    for name, m in a.items(keep_base=True, copy_state=False):
        assert table(m).replays > 0, name
        jm = j[name]
        assert m.fault_counts == jm.metric_state["_faults"].as_dict()
