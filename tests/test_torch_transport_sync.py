"""The transports and the chunked schedule of the port's ``fused_sync``
(``metrics_tpu_torch/parallel/sync.py``) against the JAX package's own
``fused_sync`` run under ``jax.vmap(..., axis_name="d")`` over the ranks'
stacked states, and the degradation of a sync whose collective cannot
complete.

The port's ranks are threads of one process
(``tests/helpers/torch_thread_world.py::ThreadWorld``), worlds of 2 and 4,
each with its own communicator; the same seeded numpy states go through
both packages. The states: a float32 sum leaf over many decades with a NaN
lane, an int32 sum leaf, a float32 mean leaf, a float32 max leaf, and a
quantile sketch. Expected: every lane bit-equal to JAX, for the exact,
int8 and fp16 transports and for 1 and 4 chunks (the int8 and fp16
decode-and-sum runs in rank order on both sides and is bit-reproducible
on the CPU, so no tolerance is needed). A sync over a replica axis
(``lanes=``, a bootstrap's stacked states) gives each replica what its own
sync gives it, bit for bit, for every state kind, exact and int8.

A degraded sync (a collective that hangs past the bounded communicator's
timeout) takes the states' world-of-one values: an ``all_reduce`` bucket,
a mean bucket (not divided by the world size), a ring (its own
``dropped``) and a quantile payload (never unpacked from the other ranks'
zeros), each with one ``gather_degraded`` event.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.parallel.sync import fused_sync as jax_fused_sync  # noqa: E402
from metrics_tpu_torch.parallel import sync as S  # noqa: E402
from metrics_tpu_torch.resilience.health import registry  # noqa: E402
from metrics_tpu_torch.streaming.sketches import QuantileSketchState  # noqa: E402
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer  # noqa: E402
from tests.helpers.torch_thread_world import FakeWorld, ThreadWorld  # noqa: E402

REDS = [{"s": "sum", "c": "sum", "m": "mean", "mx": "max"}, {"q": None}]
SKETCH = dict(eps=0.05, max_items=1 << 14)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_SYNC_TRANSPORT", raising=False)
    monkeypatch.delenv("METRICS_TPU_SYNC_CHUNKS", raising=False)
    S.reset_sync_chunks_env_state()
    registry.clear()
    yield
    registry.clear()


def rank_data(rank):
    """A rank's states as numpy (the tensors) and as the JAX sketch state."""
    rng = np.random.default_rng(100 + rank)
    s = (rng.standard_normal(1000) * 10 ** rng.uniform(-3, 3, 1000)).astype(np.float32)
    if rank == 1:
        s[5] = np.nan
    tensors = {
        "s": s,
        "c": rng.integers(0, 1000, 7).astype(np.int32),
        "m": rng.random(40).astype(np.float32),
        "mx": rng.standard_normal(5).astype(np.float32),
    }
    q = mt.QuantileSketch(**SKETCH)
    q.update(jnp.asarray(rng.lognormal(0, 1, 700 + 100 * rank).astype(np.float32)))
    return tensors, q.metric_state["sketch"]


def port_states(rank):
    tensors, sketch = rank_data(rank)
    like = mtt.QuantileSketch(**SKETCH, device="cpu")._defaults["sketch"]
    return [{k: torch.from_numpy(v) for k, v in tensors.items()}, {"q": QuantileSketchState.from_primitives(sketch, like=like)}]


def jax_synced(world, transport, chunks):
    per = [rank_data(r) for r in range(world)]
    tensors = {k: jnp.stack([jnp.asarray(p[0][k]) for p in per]) for k in per[0][0]}
    sketches = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[p[1] for p in per])
    fn = jax.vmap(lambda a, b: jax_fused_sync([a, {"q": b}], REDS, "d", transport=transport, chunks=chunks), axis_name="d")
    out = fn(tensors, sketches)
    return [jax.tree_util.tree_map(lambda x: np.asarray(x[r]), out) for r in range(world)]


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8)


@pytest.mark.parametrize(
    "world,transport,chunks",
    [(2, "exact", 1), (2, "exact", 4), (2, "int8", 1), (2, "fp16", 4), (4, "exact", 4), (4, "int8", 4), (4, "fp16", 1)],
)
def test_fused_sync_bit_equal_to_jax_under_vmap(world, transport, chunks):
    ref = jax_synced(world, transport, chunks)
    w = ThreadWorld(world)
    outs = w.run(lambda rank, comm: S.fused_sync(port_states(rank), REDS, comm=comm, transport=transport, chunks=chunks))
    for r in range(world):
        for k in ("s", "c", "m", "mx"):
            assert np.array_equal(_bits(outs[r][0][k].numpy()), _bits(ref[r][0][k])), (r, k)
        for field in ("items", "counts", "n_seen"):
            ours, theirs = getattr(outs[r][1]["q"], field).numpy(), np.asarray(getattr(ref[r][1]["q"], field))
            # the exact transport's sum turns -0.0 into +0.0, as psum does
            assert np.array_equal(ours, theirs), (r, field)
    # the collectives: one all_reduce per chunk of each bucket (int32 sum 7
    # lanes, mean 40, max 5; the exact float32 sum bucket carries the sum
    # leaf and every rank's packed sketch); a quantized transport gathers
    # its wire once, as bytes
    reduces = [c for c in w.calls if c[0] == "all_reduce"]
    gathers = [c for c in w.calls if c[0] == "all_gather"]
    sizes = [7, 40, 5]
    if transport == "exact":
        sizes.append(1000 + world * port_states(0)[1]["q"].packed_size)
        assert gathers == []
    else:
        assert len(gathers) == 1 and gathers[0][1] == torch.uint8
    assert sorted(c[3] for c in reduces) == sorted(n // min(chunks, n) + (1 if i < n % min(chunks, n) else 0)
                                                   for n in sizes for i in range(min(chunks, n)))


@pytest.mark.parametrize("chunks", [1, 4, 1000])
def test_chunked_schedule_bit_equal_and_counted(chunks):
    """Each bucket splits into ``min(chunks, lanes)`` all_reduce calls, and
    the values are those of one collective."""
    w1, wk = ThreadWorld(2), ThreadWorld(2)
    one = w1.run(lambda rank, comm: S.fused_sync(port_states(rank), REDS, comm=comm, chunks=1))
    many = wk.run(lambda rank, comm: S.fused_sync(port_states(rank), REDS, comm=comm, chunks=chunks))
    for a, b in zip(one, many):
        for k in ("s", "c", "m", "mx"):
            assert np.array_equal(_bits(a[0][k].numpy()), _bits(b[0][k].numpy()))
        assert all(torch.equal(x, y) for x, y in zip(a[1]["q"], b[1]["q"]))
    lanes = [c[3] for c in w1.calls]
    assert len(w1.calls) == 4  # float32 sum (with the sketch payload), int32 sum, mean, max
    assert len(wk.calls) == sum(min(chunks, n) for n in lanes)
    assert sum(c[3] for c in wk.calls) == sum(lanes)


def test_chunk_count_from_the_environment(monkeypatch):
    """``METRICS_TPU_SYNC_CHUNKS`` chunks only buckets of at least
    ``SYNC_CHUNK_MIN_BYTES``; a malformed value warns once and keeps 1."""
    monkeypatch.setenv("METRICS_TPU_SYNC_CHUNKS", "4")
    S.reset_sync_chunks_env_state()
    base, w = ThreadWorld(2), ThreadWorld(2)
    base.run(lambda rank, comm: S.fused_sync(port_states(rank), REDS, comm=comm, chunks=1))
    w.run(lambda rank, comm: S.fused_sync(port_states(rank), REDS, comm=comm))
    # buckets below the floor keep one collective (all are 4-byte lanes)
    assert len(w.calls) == sum(min(4, c[3]) if 4 * c[3] >= S.SYNC_CHUNK_MIN_BYTES else 1 for c in base.calls)
    assert len(w.calls) > len(base.calls)
    monkeypatch.setenv("METRICS_TPU_SYNC_CHUNKS", "zero")
    S.reset_sync_chunks_env_state()
    with pytest.warns(UserWarning, match="METRICS_TPU_SYNC_CHUNKS"):
        assert S.resolve_sync_chunks() == 1
    assert S.resolve_sync_chunks() == 1
    with pytest.raises(Exception, match="positive integer"):
        S.resolve_sync_chunks(0)


def test_the_transport_from_the_environment(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_TRANSPORT", "int8")
    from metrics_tpu_torch.ops.quantize import reset_transport_env_state

    reset_transport_env_state()
    try:
        w = ThreadWorld(2)
        w.run(lambda rank, comm: S.fused_sync(port_states(rank), REDS, comm=comm))
        assert [c[1] for c in w.calls if c[0] == "all_gather"] == [torch.uint8]
        # an explicit exact transport is what a blocking Metric sync asks for
        w = ThreadWorld(2)
        w.run(lambda rank, comm: S.fused_sync(port_states(rank), REDS, comm=comm, transport="exact"))
        assert not [c for c in w.calls if c[0] == "all_gather"]
    finally:
        monkeypatch.delenv("METRICS_TPU_SYNC_TRANSPORT")
        reset_transport_env_state()


# --------------------------------------------------------------------------
# a degraded sync takes the world-of-one value
# --------------------------------------------------------------------------


def _degrade_states():
    tensors, q = port_states(0)
    ring = CatBuffer(torch.arange(8, dtype=torch.float32), torch.tensor([1, 1, 1, 0, 0, 0, 0, 0], dtype=torch.bool), torch.tensor(3, dtype=torch.int32))
    return [{**tensors, "ring": ring}, q], [{**REDS[0], "ring": "cat"}, REDS[1]]


@pytest.mark.parametrize(
    "case,transport,hang",
    [
        ("sum bucket", "exact", lambda n, t: n == "all_reduce" and t.dtype == torch.int32),
        ("mean bucket", "exact", lambda n, t: n == "all_reduce" and t.numel() == 40),
        ("ring", "exact", lambda n, t: n == "all_gather" and t.dtype == torch.float32),
        ("quantile payload, exact", "exact", lambda n, t: n == "all_reduce" and t.numel() > 1000),
        ("quantile payload, int8", "int8", lambda n, t: n == "all_gather" and t.dtype == torch.uint8),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_a_wedged_collective_degrades_the_sync_to_world_of_one(case, transport, hang):
    states, reds = _degrade_states()
    inner = FakeWorld(n=4, hang=hang, hang_s=5.0)
    comm = S.RetryingGather(inner, timeout_s=0.2)
    t0 = time.perf_counter()
    with pytest.warns(UserWarning, match="LOCAL-ONLY"):
        out = S.fused_sync(states, reds, comm=comm, transport=transport)
    assert time.perf_counter() - t0 < 0.2 + 1.5
    assert registry.counts() == {"gather_degraded": 1}
    want = S.fused_sync(states, reds, comm=S._WORLD_OF_ONE, transport=transport)
    for i in range(2):
        for k, v in want[i].items():
            got = out[i][k]
            pairs = zip(got, v) if isinstance(v, tuple) else [(got, v)]
            assert all(torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                             and torch.equal(a.nan_to_num(), b.nan_to_num())) for a, b in pairs), (case, k)
    # the world-of-one values are the local ones: a mean not divided, a
    # ring with its own drops, the local sketch
    assert torch.equal(out[0]["m"], states[0]["m"])
    assert int(out[0]["ring"].dropped) == 3 and out[0]["ring"].data.shape == (8,)
    assert int(out[1]["q"].n_seen) == int(states[1]["q"].n_seen)
    if transport == "exact":
        assert torch.equal(out[1]["q"].counts, states[1]["q"].counts)


def _replica_states(rank, replicas):
    """A rank's states of every kind, one set a replica: a quantile sketch,
    HyperLogLog and CountMin (elementwise sketches), a ring that overflows,
    and stacked (``None``-reduced) moments."""
    rng = np.random.default_rng(300 + rank)
    makers = {
        "q": lambda: mtt.QuantileSketch(eps=0.05, device="cpu"),
        "hll": lambda: mtt.HyperLogLog(device="cpu"),
        "cm": lambda: mtt.CountMinSketch(device="cpu"),
        "ring": lambda: mtt.SpearmanCorrCoef(capacity=16, device="cpu"),
        "moments": lambda: mtt.PearsonCorrCoef(device="cpu"),
    }
    out = {}
    for name, make in makers.items():
        out[name] = []
        for _ in range(replicas):
            m = make()
            x = torch.from_numpy(rng.lognormal(size=20 + 3 * rank).astype(np.float32))
            m.update(x) if name in ("q", "hll", "cm") else m.update(x, x + torch.from_numpy(rng.normal(size=x.shape[0]).astype(np.float32)))
            out[name].append(m.metric_state)
    return out, {name: dict(make()._reductions) for name, make in makers.items()}


@pytest.mark.parametrize("transport", ["exact", "int8"])
def test_a_replica_axis_syncs_each_replica_as_its_own_sync(transport):
    """``fused_sync(..., lanes=B)`` over states stacked on a replica axis (a
    bootstrap's) gives every replica, bit for bit, what the sync of that
    replica's states alone gives it, for every state kind, with the
    collectives of one replica's sync."""
    from metrics_tpu_torch.pure import _replica, _stack

    replicas = 3

    def body(rank, comm):
        states, reds = _replica_states(rank, replicas)
        names = sorted(states)
        stacked = S.fused_sync([_stack(states[n]) for n in names], [reds[n] for n in names], None, comm=comm,
                               transport=transport, lanes=replicas)
        per_replica = [S.fused_sync([states[n][b] for n in names], [reds[n] for n in names], None, comm=comm, transport=transport)
                       for b in range(replicas)]
        return names, stacked, per_replica

    world = ThreadWorld(3)
    results = world.run(body)
    calls = [c[:2] for c in world.calls]
    assert calls[: len(calls) // (replicas + 1)] * (replicas + 1) == calls  # the stack's sync makes one replica's collectives
    for names, stacked, per_replica in results:
        for i, name in enumerate(names):
            for b in range(replicas):
                got, want = _replica(stacked[i], b), per_replica[b][i]
                for key in want:
                    for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (got[key], want[key]))):
                        assert torch.equal(x, y), (transport, name, key, b)
