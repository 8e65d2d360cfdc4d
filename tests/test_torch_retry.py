"""The port's failure budget (``metrics_tpu_torch/parallel/retry.py``) and
bounded communicator (``parallel/sync.py::RetryingGather``), in the cases
of ``tests/parallel/test_retry.py`` and
``tests/integrations/test_gather_transport.py``.

Each ``RetryPolicy`` case runs through the port's policy and the JAX
package's (``metrics_tpu/parallel/retry.py``, standard library only) and
expects the same outcome. The JAX ``RetryingGather`` wraps a gather
(``array -> (nproc, ...)``); the port's wraps a communicator
(``all_reduce``, ``all_gather``), so its cases run over a fake world
(``tests/helpers/torch_thread_world.py::FakeWorld``) whose collectives
hang or raise where a case says.
"""
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from metrics_tpu.parallel import retry as jax_retry  # noqa: E402
from metrics_tpu_torch import metric as metric_mod  # noqa: E402
from metrics_tpu_torch.parallel import retry as port_retry  # noqa: E402
from metrics_tpu_torch.parallel import sync as S  # noqa: E402
from metrics_tpu_torch.resilience.health import registry  # noqa: E402
from tests.helpers.torch_thread_world import FakeWorld  # noqa: E402

import metrics_tpu_torch as mtt  # noqa: E402

IMPLS = {"port": port_retry, "jax": jax_retry}


@pytest.fixture(autouse=True)
def _fresh_registry():
    registry.clear()
    yield
    registry.clear()


class Flaky:
    def __init__(self, fail_times):
        self.fail_times = fail_times
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise ConnectionError("injected failure")
        return "ok"


# --------------------------------------------------------------------------
# RetryPolicy, the port's against the JAX package's
# --------------------------------------------------------------------------


def _outcome(impl, fn, **kw):
    policy = impl.RetryPolicy(**kw)
    try:
        return ("ok", policy.call(fn), policy.open)
    except impl.RetryBudgetExceededError as err:
        return ("exhausted", err.attempts, type(err.cause).__name__, policy.open)


@pytest.mark.parametrize(
    "fail_times,max_retries",
    [(0, 2), (2, 2), (10, 2), (10, 0)],
    ids=["passes", "retries-then-succeeds", "budget-spent", "no-retries"],
)
def test_policy_outcomes_match_jax(fail_times, max_retries):
    outcomes = {}
    for name, impl in IMPLS.items():
        fn = Flaky(fail_times)
        outcomes[name] = (_outcome(impl, fn, timeout_s=5.0, max_retries=max_retries, backoff_s=0.01, cooldown_s=30.0), fn.calls)
    assert outcomes["port"] == outcomes["jax"]


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_circuit_open_skips_the_callable_then_closes(impl):
    mod = IMPLS[impl]
    policy = mod.RetryPolicy(timeout_s=5.0, max_retries=0, backoff_s=0.01, cooldown_s=30.0)
    fn = Flaky(10)
    with pytest.raises(mod.RetryBudgetExceededError):
        policy.call(fn)
    t0 = time.perf_counter()
    with pytest.raises(mod.CircuitOpenError) as info:
        policy.call(fn)
    assert time.perf_counter() - t0 < 0.05 and fn.calls == 1 and info.value.retry_in_s > 0
    policy.close()  # the cooldown has passed
    assert policy.call(Flaky(0)) == "ok" and not policy.open


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_timeouts_run_once_unless_opted_in(impl):
    mod = IMPLS[impl]
    calls = []

    def hang():
        calls.append(1)
        time.sleep(5.0)

    with pytest.raises(mod.RetryBudgetExceededError) as info:
        mod.RetryPolicy(timeout_s=0.1, max_retries=3, backoff_s=0.01).call(hang)
    assert info.value.attempts == 1 and len(calls) == 1 and isinstance(info.value.cause, mod.CallTimeoutError)

    calls.clear()

    def slow_then_fast():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(5.0)
        return "ok"

    assert mod.RetryPolicy(timeout_s=0.2, max_retries=1, backoff_s=0.01, retry_timeouts=True).call(slow_then_fast) == "ok"
    assert len(calls) == 2


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_custom_timeout_error_and_daemon_attempts(impl):
    mod = IMPLS[impl]

    class MyTimeout(RuntimeError):
        pass

    policy = mod.RetryPolicy(timeout_s=0.1, max_retries=0, timeout_error=MyTimeout, thread_name=f"retry-test-{impl}")
    with pytest.raises(mod.RetryBudgetExceededError) as info:
        policy.call(lambda: time.sleep(3.0))
    assert isinstance(info.value.cause, MyTimeout)
    workers = [t for t in threading.enumerate() if t.name == f"retry-test-{impl}"]
    assert workers and all(t.daemon for t in workers)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_rejects_nonsense_budgets(impl):
    with pytest.raises(ValueError):
        IMPLS[impl].RetryPolicy(timeout_s=0.0)
    with pytest.raises(ValueError):
        IMPLS[impl].RetryPolicy(max_retries=-1)


# --------------------------------------------------------------------------
# RetryingGather: a bounded communicator
# --------------------------------------------------------------------------


def _gather(comm, x):
    parts = [torch.empty_like(x) for _ in range(comm.get_world_size())]
    return None if comm.all_gather(parts, x) is S.DEGRADED else parts


def test_healthy_world_passes_through_and_records_nothing():
    plain, inner = FakeWorld(n=3), FakeWorld(n=3)
    g = S.RetryingGather(inner, timeout_s=5.0)
    x = torch.arange(4.0)
    a, b = x.clone(), x.clone()
    plain.all_reduce(a)
    assert g.all_reduce(b) is None and torch.equal(a, b)
    assert [torch.equal(p, x) for p in _gather(g, x)] == [True] * 3
    assert len(inner.calls) == 2 and registry.counts() == {}


def test_flaky_collective_retried_with_backoff():
    inner = FakeWorld(n=2, fail=lambda name, t: len(inner.calls) <= 2)
    g = S.RetryingGather(inner, timeout_s=5.0, max_retries=2, backoff_s=0.01)
    x = torch.ones(3)
    assert g.all_reduce(x) is None and torch.equal(x, torch.full((3,), 2.0))
    assert len(inner.calls) == 3 and registry.counts() == {}


def test_hanging_collective_returns_within_timeout_and_degrades():
    """A wedged peer costs the timeout: the collective comes back DEGRADED,
    its tensor untouched (this rank's own value), with one health event."""
    inner = FakeWorld(n=2, hang=lambda name, t: True, hang_s=5.0)
    g = S.RetryingGather(inner, timeout_s=0.2, max_retries=1, backoff_s=0.01)
    x = torch.arange(5.0)
    t0 = time.perf_counter()
    with pytest.warns(UserWarning, match="LOCAL-ONLY"):
        out = g.all_reduce(x)
    assert time.perf_counter() - t0 < 3.0
    assert out is S.DEGRADED and torch.equal(x, torch.arange(5.0))
    assert registry.counts() == {"gather_degraded": 1}
    assert registry.events()[0]["details"]["timed_out"] is True
    # a timed-out collective is never issued again, nor anything after it
    t1 = time.perf_counter()
    assert _gather(g, x) is None and g.all_reduce(x) is S.DEGRADED
    assert time.perf_counter() - t1 < 0.05 and len(inner.calls) == 1
    assert registry.counts() == {"gather_degraded": 1}


def test_dead_collective_degrades_loudly_then_the_breaker_skips():
    inner = FakeWorld(n=2, fail=lambda name, t: True)
    g = S.RetryingGather(inner, timeout_s=1.0, max_retries=2, backoff_s=0.01, cooldown_s=30.0)
    with pytest.warns(UserWarning, match="degrading to LOCAL-ONLY"):
        assert _gather(g, torch.ones(2, 3)) is None
    assert len(inner.calls) == 3
    t0 = time.perf_counter()
    assert g.all_reduce(torch.ones(2)) is S.DEGRADED  # the breaker is open: nothing issued
    assert time.perf_counter() - t0 < 0.05 and len(inner.calls) == 3
    # the cooldown has passed and the world is healthy again: the breaker closes
    g._policy.close()
    g.comm = FakeWorld(n=2)
    x = torch.ones(2)
    assert g.all_reduce(x) is None and torch.equal(x, torch.full((2,), 2.0))
    assert registry.counts() == {"gather_degraded": 1}


def test_no_fallback_raises():
    g = S.RetryingGather(FakeWorld(fail=lambda name, t: True), timeout_s=1.0, max_retries=1, backoff_s=0.01, fallback_local=False)
    with pytest.raises(ConnectionError):
        g.all_reduce(torch.ones(2))
    g = S.RetryingGather(FakeWorld(hang=lambda name, t: True, hang_s=5.0), timeout_s=0.1, max_retries=0, fallback_local=False)
    with pytest.raises(S.GatherTimeoutError):
        g.all_reduce(torch.ones(2))
    with pytest.raises(S.GatherTimeoutError, match="timed out earlier"):
        g.all_reduce(torch.ones(2))
    workers = [t for t in threading.enumerate() if t.name == "metrics-tpu-gather"]
    assert workers and all(t.daemon for t in workers)


def test_degraded_payload_gather_keeps_local_rows():
    """The header gather succeeds (rank 0 claims 3 rows) and the payload
    gather degrades: the rows are this rank's own, trimmed by its own
    shape."""
    inner = FakeWorld(n=2, rank=1, fail=lambda name, t: len(inner.calls) >= 2)
    g = S.RetryingGather(inner, timeout_s=5.0, max_retries=0)
    local = torch.arange(5, dtype=torch.int32)
    with pytest.warns(UserWarning):
        out = S.gather_all_arrays(local, comm=g)
    assert len(out) == 1 and torch.equal(out[0], local)


def test_degraded_header_then_recovered_payload_keeps_local_rows():
    class HeaderDegraded(FakeWorld):
        def all_gather(self, parts, tensor, group=None):
            if not self.calls:
                self.calls.append("header")
                return S.DEGRADED
            parts[0].zero_()
            parts[1].copy_(tensor)

    local = torch.arange(4, dtype=torch.int32) + 10
    out = S.gather_all_arrays(local, comm=HeaderDegraded())
    assert len(out) == 1 and torch.equal(out[0], local)


def test_pad_gather_trim_through_a_flaky_world():
    inner = FakeWorld(n=2, fail=lambda name, t: len(inner.calls) == 1)
    out = S._pad_gather_trim(torch.arange(6, dtype=torch.int32), None, S.RetryingGather(inner, timeout_s=5.0, backoff_s=0.01))
    assert len(out) == 2 and torch.equal(out[0], torch.arange(6, dtype=torch.int32))


def test_set_gather_transport_reaches_a_metric_sync(monkeypatch):
    """The default communicator of every sync: a flaky two-rank world behind
    it gives the two-rank value."""
    monkeypatch.setattr(metric_mod, "distributed_available", lambda: True)
    inner = FakeWorld(n=2, fail=lambda name, t: len(inner.calls) == 1)
    prev = S.set_gather_transport(S.RetryingGather(inner, timeout_s=5.0, backoff_s=0.01))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = mtt.SumMetric(nan_strategy="ignore", device="cpu")
            m.update(torch.tensor([2.0]))
            m.sync()
            assert float(m._state["value"]) == 4.0  # two ranks of 2.0
            m.unsync()
        assert len(inner.calls) == 2 and registry.counts() == {}
    finally:
        S.set_gather_transport(prev)


def test_a_wedged_world_degrades_a_metric_sync_to_its_own_value(monkeypatch):
    monkeypatch.setattr(metric_mod, "distributed_available", lambda: True)
    prev = S.set_gather_transport(S.RetryingGather(FakeWorld(n=4, hang=lambda n, t: True, hang_s=5.0), timeout_s=0.2))
    try:
        m = mtt.MeanMetric(device="cpu")
        m.update(torch.tensor([1.0, 2.0, 6.0]))
        t0 = time.perf_counter()
        with pytest.warns(UserWarning, match="LOCAL-ONLY"):
            value = m.compute()
        assert time.perf_counter() - t0 < 2.0 and float(value) == 3.0
        assert registry.counts() == {"gather_degraded": 1}
    finally:
        S.set_gather_transport(prev)


def test_jax_and_port_share_the_defaults():
    from metrics_tpu.parallel.sync import RetryingGather as JaxRetryingGather

    jg, tg = JaxRetryingGather(lambda a: np.asarray(a)[None]), S.RetryingGather(FakeWorld())
    for attr in ("timeout_s", "cooldown_s", "fallback_local"):
        assert getattr(jg, attr) == getattr(tg, attr), attr
    assert jg._policy.max_retries == tg._policy.max_retries and jg._policy.backoff_s == tg._policy.backoff_s
