"""The port's ``Metric`` runtime: the forward protocols, reset, clone and
pickling, ``state_dict``/``load_state_dict`` checks, the compute cache, and
the refusal to compute unsynced in a multi-process world. States are updated
in place in PyTorch, so every copy the runtime keeps must be independent."""
import pickle
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch import metric as metric_mod  # noqa: E402
from metrics_tpu_torch.metric import Metric  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402
from tests.helpers.torch_twin_world import TwinWorld  # noqa: E402

C = 5


def _batch(seed, n=20):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n, C)).astype(np.float32)), torch.from_numpy(rng.integers(0, C, n))


class SumAndMax(Metric):
    """Every reduction tag at once; ``full_state_update`` is set per test."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("avg", torch.tensor(0.0), dist_reduce_fx="mean")
        self.add_state("hi", torch.tensor(float("-inf")), dist_reduce_fx="max")
        self.add_state("lo", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("seen", [], dist_reduce_fx="cat")

    def update(self, x):
        self.total += x.sum()
        self.avg = x.mean()
        self.hi = torch.maximum(self.hi, x.max())
        self.lo = torch.minimum(self.lo, x.min())
        self.seen.append(x)

    def compute(self):
        return self.total, self.avg, self.hi, self.lo, torch.cat(self.seen).numel()


@pytest.mark.parametrize("full_state", [False, True])
def test_forward_protocols_give_batch_and_global_values(full_state):
    m = SumAndMax(device="cpu")
    m.full_state_update = full_state
    xs = [torch.tensor([1.0, 2.0]), torch.tensor([5.0]), torch.tensor([-1.0, 0.5, 3.0])]
    for x in xs:
        total, avg, hi, lo, n = m(x)
        assert float(total) == float(x.sum()) and float(hi) == float(x.max()) and n == x.numel()
    total, avg, hi, lo, n = m.compute()
    allx = torch.cat(xs)
    assert float(total) == float(allx.sum()) and float(hi) == 5.0 and float(lo) == -1.0 and n == 6
    assert m.update_count == 3


def test_reset_restores_untouched_defaults():
    acc = mtt.Accuracy(num_classes=C, device="cpu")
    acc.update(*_batch(0))
    assert int(acc.tp) > 0
    acc.reset()
    assert int(acc.tp) == 0 and int(acc._defaults["tp"]) == 0
    acc.update(*_batch(1))
    assert int(acc._defaults["tp"]) == 0  # in-place updates never reach the default


def test_clone_and_pickle_are_independent():
    acc = mtt.Accuracy(num_classes=C, device="cpu")
    acc.update(*_batch(0))
    twin = acc.clone()
    thawed = pickle.loads(pickle.dumps(acc))
    for m in (twin, thawed):
        m.update(*_batch(1))
    acc.update(*_batch(1))
    assert torch.equal(twin.compute(), acc.compute()) and torch.equal(thawed.compute(), acc.compute())
    twin.update(*_batch(2))
    assert int(twin.tp) != int(acc.tp)


def test_compute_cache_and_warning():
    acc = mtt.Accuracy(num_classes=C, device="cpu")
    with pytest.warns(UserWarning, match="called before the ``update``"):
        with pytest.raises(RuntimeError, match="mode"):
            acc.compute()
    acc.update(*_batch(0))
    first = acc.compute()
    assert acc.compute() is first  # cached until the next update
    acc.update(*_batch(1))
    assert acc.compute() is not first


def test_forward_cache_and_value_match_jax():
    ours = mtt.Accuracy(num_classes=C, device="cpu")
    ref = mt.Accuracy(num_classes=C)
    preds, target = _batch(3)
    val = ours(preds, target)
    assert torch.equal(ours._forward_cache, val)
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()))))


def test_state_dict_round_trip_and_persistence():
    src = mtt.BinnedAveragePrecision(num_classes=C, thresholds=7, device="cpu")
    src.update(*_batch(0))
    assert src.state_dict() == {}  # states are not persistent by default
    src.persistent(True)
    sd = src.state_dict(prefix="m.")
    assert set(sd) == {"m.TPs", "m.FPs", "m.FNs"}
    sd["m.TPs"].add_(1)  # a copy: the metric is untouched
    assert not torch.equal(sd["m.TPs"], src.TPs)
    sd["m.TPs"].sub_(1)
    dst = mtt.BinnedAveragePrecision(num_classes=C, thresholds=7, device="cpu")
    dst.load_state_dict(sd, prefix="m.")
    for a, b in zip(dst.compute(), src.compute()):
        assert torch.equal(a, b)
    # numpy arrays load too, cast to the state dtype
    dst.load_state_dict({k[2:]: v.numpy().astype(np.float64) for k, v in sd.items()})
    assert dst.TPs.dtype == torch.float32


@pytest.mark.parametrize(
    ("value", "match"),
    [
        (np.zeros((2,), np.int32), "shape"),
        (np.zeros((), np.float32), "dtype"),
        (np.array("x", dtype=object), "numeric"),
    ],
)
def test_load_state_dict_refuses_bad_values(value, match):
    acc = mtt.Accuracy(num_classes=C, device="cpu")
    acc.update(*_batch(0))
    before = int(acc.tp)
    with pytest.raises(ValueError, match=match):
        acc.load_state_dict({"fp": np.zeros((), np.int32), "tp": value})
    assert int(acc.tp) == before and int(acc.fp) != 0  # nothing was loaded


def test_compute_refuses_an_unsynced_value_in_a_multi_process_world(monkeypatch):
    """In a world of more than one process compute() syncs first (here
    through an injected two-rank communicator whose other rank saw the same
    batch: the fused sync sends the four int32 sum states as one bucket, so
    it reduces once); the forward batch value stays local by design."""
    two_ranks = TwinWorld()
    acc = mtt.Accuracy(num_classes=C, device="cpu", dist_sync_fn=two_ranks)
    monkeypatch.setattr(metric_mod, "distributed_available", lambda: True)
    preds, target = _batch(0)
    batch_val = acc(preds, target)
    assert 0.0 <= float(batch_val) <= 1.0 and two_ranks.calls == []
    local = {k: v.clone() for k, v in acc.metric_state.items()}
    value = acc.compute()
    assert [c[0] for c in two_ranks.calls] == ["all_reduce"] and two_ranks.calls[0][1].numel() == len(local)
    assert torch.equal(value, batch_val)
    assert all(torch.equal(acc.metric_state[k], v) for k, v in local.items())  # the local state is back
    with pytest.raises(MetricsTPUUserError, match="already been un-synced"):
        acc.unsync()


def test_inputs_move_to_the_metric_device():
    acc = mtt.Accuracy(num_classes=C, device="cpu")
    preds, target = _batch(0)
    acc.update(preds.numpy(), target.numpy())
    ref = mtt.Accuracy(num_classes=C, device="cpu")
    ref.update(preds, target)
    assert torch.equal(acc.compute(), ref.compute())


def test_constructor_errors():
    with pytest.raises(ValueError, match="Unexpected keyword"):
        mtt.Accuracy(device="cpu", not_an_option=True)
    # the overlapped mode is ported: its arguments are checked, not refused
    with pytest.raises(ValueError, match="sync_mode"):
        mtt.Accuracy(device="cpu", sync_mode="weird")
    with pytest.raises(ValueError, match="on_invalid"):
        mtt.Accuracy(device="cpu", on_invalid="skip")
    with pytest.raises(ValueError, match="dist_reduce_fx"):
        SumAndMax(device="cpu").add_state("x", torch.tensor(0), dist_reduce_fx="median")
    with pytest.raises(ValueError, match="empty list"):
        SumAndMax(device="cpu").add_state("x", [1])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mtt.StatScores(device="cpu")
