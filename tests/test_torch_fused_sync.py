"""The port's fused multi-process sync (``parallel/sync.py::fused_sync``,
``MetricCollection.compute`` and ``sync_states``) in spawned Gloo worlds of
2 and 4 processes on the CPU, one world per size running every check once
(the ranks live in ``tests/helpers/torch_fused_sync_ranks.py`` and import
neither JAX nor ``metrics_tpu``).

Counted by a recording wrapper around ``torch.distributed``, a
collection's ``compute()`` makes no ``all_gather`` for tensor or sketch
states, and one ``all_reduce`` per (reduction, dtype) bucket:

- the registry's ``fused_stat_collection`` twin syncs in exactly 1;
- ``guarded_collection`` and ``sketch_guarded_collection`` in at most 2;
- ``forward`` makes none.

Values: counts and fault counts bit-equal, float32 ratios within ``ATOL``,
against the JAX collection run over the concatenated stream; the synced
stat states bit-equal to JAX ``fused_sync`` under ``shard_map`` over as
many of the conftest's CPU devices; the sketch sync bit-equal to an
in-process ``sketch_merge`` fold of the ranks' sketches (the JAX sharded
sketch sync does not run on this machine's jax, ROADMAP F0), with the
quantile items compared by value (the sum turns ``-0.0`` into ``+0.0``, as
JAX's ``psum`` does); the mean within ``MEAN_RTOL``.

F3: a samplewise list state of an empty rank gathers in its template's
dtype and number of dimensions, and the world computes the
single-process value.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu.parallel.sync import fused_sync as jax_fused_sync  # noqa: E402
from tests.helpers import torch_fused_sync_ranks as R  # noqa: E402

ATOL = 1e-6  # float32 ratios, averaged over classes in another order
MEAN_RTOL = 1e-6  # a float32 mean of ~2000 rows, summed in another order
AREA_ATOL = 1e-6


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    store = tmp_path_factory.mktemp(f"fused{n}") / "store"
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


def _close(ours, ref, atol=0.0):
    if isinstance(ref, dict):
        assert set(ours) == set(ref)
        for k in ref:
            _close(ours[k], ref[k], atol)
        return
    if isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _close(a, b, atol)
        return
    a, b = np.asarray(ours), np.asarray(ref)
    assert a.shape == b.shape
    if atol:
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(a, b)


def _jax_feed(coll, rows, extra=False):
    """What a rank feeds, through the JAX package (``extra``: the three rows
    that the rank updates with after its synced compute)."""
    for i, batch in enumerate(R.batches(rows)):
        args = [jnp.asarray(c) for c in batch]
        if i == 0:
            coll(*args)
        else:
            coll.update(*args)
    if extra and rows[0].shape[0]:
        coll.update(*[jnp.asarray(c[:3]) for c in rows])
    return coll


def _jax_over_stream(build, parts):
    """The JAX collection over the concatenated stream, one batch per rank."""
    coll = build(mt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for rows in parts:
            if rows[0].shape[0]:
                coll.update(*[jnp.asarray(c) for c in rows])
        return {k: np.asarray(v) for k, v in coll.compute().items()}, coll


def _all_reduces(calls):
    return [c for c in calls if c[0] == "all_reduce"]


def test_ranks_import_no_jax(world):
    _, results = world
    assert all(res["jax_loaded"] == [] for res in results)


def test_stat_collection_syncs_in_one_all_reduce(world):
    n, results = world
    for res in results:
        calls = res["stat"]["compute_calls"]
        assert len(_all_reduces(calls)) == 1 and calls == _all_reduces(calls), calls
        assert _all_reduces(calls)[0][1] == "int32"
        assert res["stat"]["forward_calls"] == []
        for key in ("guarded", "sketch"):
            calls = res[key]["compute_calls"]
            assert 1 <= len(_all_reduces(calls)) <= 2 and calls == _all_reduces(calls), (key, calls)
            assert res[key]["forward_calls"] == []
    assert sorted(c[1] for c in _all_reduces(results[0]["guarded"]["compute_calls"])) == ["int32", "int64"]
    assert sorted(c[1] for c in _all_reduces(results[0]["sketch"]["compute_calls"])) == ["float32", "int64"]


@pytest.mark.parametrize("key", ["stat", "guarded"])
def test_values_match_the_jax_collection_over_the_stream(world, key):
    n, results = world
    build = R.stat_collection if key == "stat" else R.guarded_collection
    ref, _ = _jax_over_stream(build, R.shards(key, n))
    for res in results:
        _close(res[key]["values"], ref, ATOL)
        # every rank reads the same value, bit for bit
        _close(res[key]["values"], results[0][key]["values"])


def test_fault_counts_are_global_and_bit_equal_to_jax(world):
    """Each rank's own counts while local; after the sync the world's on
    every rank: numpy's count of the injected rows (the rank's rows and the
    three it updates with after its compute), and JAX's over the same."""
    n, results = world
    parts = R.shards("guarded", n)
    seen = [(p, t) for p, t in parts] + [(p[:3], t[:3]) for p, t in parts]
    nan_rows = sum(int(np.isnan(p).any(1).sum()) for p, _ in seen)
    label_rows = sum(int((t == R.C).sum()) for _, t in seen)
    assert nan_rows > 0 and label_rows > 0
    local = _jax_local_states(R.guarded_collection, parts, extra=True)
    for name in ("acc", "f1"):
        want = np.sum([np.asarray(st[name]["_faults"].counts).astype(np.int64) for st in local], axis=0)
        assert list(want[:4]) == [nan_rows, 0, 0, label_rows]
        for r, res in enumerate(results):
            np.testing.assert_array_equal(res["guarded"]["synced"][name]["_faults"]["counts"], want)
            own = np.asarray(_jax_local_states(R.guarded_collection, [parts[r]], extra=False)[0][name]["_faults"].counts)
            assert list(res["guarded"]["faults"][name].values()) == own.astype(np.int64).tolist()


def _jax_local_states(build, parts, extra):
    """Each rank's local JAX states (as the port's rank fed them), by member."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        colls = [_jax_feed(build(mt), rows, extra) for rows in parts]
    return [{k: dict(m.metric_state) for k, m in c.items(keep_base=True, copy_state=True)} for c in colls]


def _jax_shard_map_sync(local, reductions):
    """JAX ``fused_sync`` under ``shard_map`` over ``len(local)`` CPU
    devices, each holding one rank's states (a list of member states)."""
    n = len(local)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *local)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

    def step(states):
        return jax_fused_sync(jax.tree_util.tree_map(lambda x: x[0], states), reductions, "data")

    return jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P("data"),), out_specs=P()))(stacked)


@pytest.mark.parametrize("key", ["stat", "guarded"])
def test_synced_states_match_jax_fused_sync_under_shard_map(world, key):
    n, results = world
    build = R.stat_collection if key == "stat" else R.guarded_collection
    local = _jax_local_states(build, R.shards(key, n), extra=True)
    names = sorted(local[0])
    reductions = [dict(build(mt)[k]._reductions) for k in names]
    synced = dict(zip(names, _jax_shard_map_sync([[st[k] for k in names] for st in local], reductions)))
    for res in results:
        for name in names:
            for state, value in synced[name].items():
                ours = res[key]["synced"][name][state]
                if state == "_faults":
                    np.testing.assert_array_equal(ours["counts"], np.asarray(value.counts).astype(np.int64))
                else:
                    assert ours.dtype == np.asarray(value).dtype
                    np.testing.assert_array_equal(ours, np.asarray(value))


def test_members_read_their_local_state_after_a_synced_compute(world):
    """After ``compute()`` every member points at its head's local state:
    an update reaches the whole group, and the states are those of the
    rank's own rows, as on the port in one process."""
    n, results = world
    for key, build in (("stat", R.stat_collection), ("guarded", R.guarded_collection), ("sketch", R.sketch_collection)):
        parts = R.shards(key, n)
        for r, res in enumerate(results):
            _close(res[key]["after_compute"], res[key]["local"])
            if "after_update" not in res[key]:
                continue
            ref = build(mtt, device="cpu")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for i, batch in enumerate(R.batches(parts[r])):
                    args = [torch.from_numpy(np.ascontiguousarray(c)) for c in batch]
                    ref(*args) if i == 0 else ref.update(*args)
                ref.update(*[torch.from_numpy(np.ascontiguousarray(c[:3])) for c in parts[r]])
            want = {name: m.metric_state for name, m in ref.items(keep_base=True, copy_state=False)}
            for name, states in want.items():
                for state, value in states.items():
                    got = res[key]["after_update"][name][state]
                    if hasattr(value, "_fields"):
                        for field, v in zip(value._fields, value):
                            np.testing.assert_array_equal(got[field], v.numpy())
                    else:
                        np.testing.assert_array_equal(got, value.numpy())


def test_sketch_sync_equals_the_in_process_fold(world):
    """The synced states (taken after each rank's three further rows)
    against the ranks' local states, folded in rank order in this process."""
    n, results = world
    parts = R.shards("sketch", n)
    local = [res["sketch"]["after_update"] for res in results]
    folded = None
    for st in local:
        s = mtt.QuantileSketchState(*(torch.from_numpy(st["q"]["sketch"][f]) for f in mtt.QuantileSketchState._fields))
        folded = s if folded is None else folded.sketch_merge(s)
    finite = sum(int(np.isfinite(p).sum()) + int(np.isfinite(p[:3]).sum()) for (p,) in parts)
    for res in results:
        got = res["sketch"]["synced"]["q"]["sketch"]
        # items by value: the sum turns -0.0 into +0.0
        assert np.array_equal(got["items"], folded.items.numpy())
        np.testing.assert_array_equal(got["counts"], folded.counts.numpy())
        assert int(got["n_seen"]) == int(folded.n_seen) == finite
        np.testing.assert_array_equal(res["sketch"]["synced"]["cm"]["sketch"]["counts"], sum(st["cm"]["sketch"]["counts"] for st in local))
        for name in ("q", "mean"):
            want = sum(st[name]["_faults"]["counts"] for st in local)
            np.testing.assert_array_equal(res["sketch"]["synced"][name]["_faults"]["counts"], want)


def test_sketch_collection_values_against_jax(world):
    n, results = world
    parts = R.shards("sketch", n)
    ref, _ = _jax_over_stream(R.sketch_collection, parts)
    local = _jax_local_states(R.sketch_collection, parts, extra=False)
    assert np.isnan(ref["mean"])  # the stream holds both infinities
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["sketch"]["values"]["mean"], ref["mean"], rtol=MEAN_RTOL)
        np.testing.assert_array_equal(res["sketch"]["values"]["cm"], ref["cm"].astype(np.int64))
        for name in ("q", "mean"):
            want = np.asarray(local[r][name]["_faults"].counts).astype(np.int64)
            assert want[0] > 0
            np.testing.assert_array_equal(res["sketch"]["local"][name]["_faults"]["counts"], want)


def test_sketch_collection_mean_over_nan_rows_against_jax(world):
    """A stream with NaN rows only: the collection's synced mean is finite
    and held within ``MEAN_RTOL`` against JAX and numpy, NaN never equal;
    its synced sums against the ranks' local sums."""
    n, results = world
    parts = R.shards("sketch_nan", n)
    ref, _ = _jax_over_stream(R.sketch_collection, parts)
    rows = np.concatenate([p for (p,) in parts]).astype(np.float64)
    assert np.isfinite(ref["mean"]) and np.isnan(rows).any()
    np.testing.assert_allclose(ref["mean"], np.nanmean(rows), rtol=MEAN_RTOL)
    local = [res["sketch_nan"]["after_update"]["mean"] for res in results]
    for res in results:
        np.testing.assert_allclose(res["sketch_nan"]["values"]["mean"], ref["mean"], rtol=MEAN_RTOL, equal_nan=False)
        synced = res["sketch_nan"]["synced"]["mean"]
        np.testing.assert_allclose(synced["value"], sum(st["value"] for st in local), rtol=MEAN_RTOL, equal_nan=False)
        np.testing.assert_array_equal(synced["weight"], sum(st["weight"] for st in local))


def test_a_compute_group_gathers_its_list_states_once(world):
    """AUROC and AP share their list states: one gather of each list (a
    header and a payload), and one vote that every rank formed the group."""
    n, results = world
    p = np.concatenate([s[0] for s in R.shards("curve", n)])
    y = np.concatenate([s[1] for s in R.shards("curve", n)])
    ref = {"auroc": float(mtt.functional.classification.auroc(torch.from_numpy(p), torch.from_numpy(y))),
           "ap": float(mtt.functional.classification.average_precision(torch.from_numpy(p), torch.from_numpy(y)))}
    for res in results:
        calls = res["curve"]["compute_calls"]
        assert res["curve"]["groups"] == [["ap", "auroc"]]
        assert calls.count(("all_gather",)) == 4 and _all_reduces(calls) == [("all_reduce", "int64", str(_max_op()))]
        for k, v in ref.items():
            assert abs(float(res["curve"]["values"][k]) - v) <= AREA_ATOL


def _max_op():
    return torch.distributed.ReduceOp.MAX


def test_empty_rank_samplewise_list_state(world):
    """F3: only rank 0 has a batch; the others send their template."""
    n, results = world
    rng = np.random.default_rng(R.SEED + 5)
    preds, target = rng.integers(0, 3, R.F3_SHAPE), rng.integers(0, 3, R.F3_SHAPE)
    for name, metric in (
        ("precision", mtt.Precision(num_classes=3, average="macro", mdmc_average="samplewise", device="cpu")),
        ("stat_scores", mtt.StatScores(reduce="macro", num_classes=3, mdmc_reduce="samplewise", device="cpu")),
        ("micro", mtt.Recall(num_classes=3, average="micro", mdmc_average="samplewise", device="cpu")),
    ):
        metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        want = metric.compute().numpy()
        for res in results:
            np.testing.assert_array_equal(res["f3"][name], want)


def test_ragged_gather_reconciles_an_empty_rank_and_refuses_a_mismatch(world):
    n, results = world
    for res in results:
        parts = res["ragged"]
        assert [p.shape for p in parts[:-1]] == [(r + 1, 3) for r in range(n - 1)]
        assert parts[-1].shape == (0, 3) and all(p.dtype == np.int32 for p in parts)
        assert res["mismatch"] is not None and "different dtypes" in res["mismatch"]


def test_sketch_sync_bit_equal_to_jax_fused_sync_under_vmap(world):
    """The sketch branch against the reference itself: the ranks' local
    sketches (after their three further rows), stacked, through the JAX
    package's ``fused_sync`` under ``jax.vmap`` (which runs on this
    machine's jax, where its ``shard_map`` form does not, F0). Items by
    value: both sums turn ``-0.0`` into ``+0.0``."""
    from metrics_tpu.streaming.sketches import QuantileSketchState as JaxSketch

    n, results = world
    local = [res["sketch"]["after_update"]["q"]["sketch"] for res in results]
    stacked = JaxSketch(*(jnp.stack([jnp.asarray(st[f]) for st in local]) for f in JaxSketch._fields))
    synced = jax.vmap(lambda s: jax_fused_sync([{"sketch": s}], [{"sketch": None}], "d")[0]["sketch"], axis_name="d")(stacked)
    for r, res in enumerate(results):
        got = res["sketch"]["synced"]["q"]["sketch"]
        for field in JaxSketch._fields:
            assert np.array_equal(got[field], np.asarray(getattr(synced, field))[r]), (r, field)


def test_int16_travels_as_bytes(world):
    """``_pad_gather_trim`` and a list state in int16 over Gloo, which
    carries no int16: the payload travels as a byte view."""
    n, results = world
    want = [(np.arange(3 * (r + 1), dtype=np.int16) * 1000 - 9).reshape(-1, 3) for r in range(n)]
    for res in results:
        assert [p.dtype for p in res["int16"]] == [np.int16] * n
        for got, w in zip(res["int16"], want):
            np.testing.assert_array_equal(got, w)
        for got, w in zip(res["int16_list"], want):
            np.testing.assert_array_equal(got, w)


def test_int8_transport_over_gloo_against_jax_under_vmap(world):
    """``fused_sync(transport="int8", chunks=2)`` over Gloo through the default
    bounded communicator: one byte ``all_gather`` of the wire, two
    ``all_reduce`` per bucket. The quantized sum and the counts are
    bit-equal to JAX's ``fused_sync`` under ``jax.vmap``; the mean bucket is
    Gloo's float32 sum, whose order over four ranks is Gloo's own, so it is
    held to ``MEAN_RTOL``."""
    n, results = world
    per = [R.transport_states(r) for r in range(n)]
    stacked = {k: jnp.stack([jnp.asarray(p[k]) for p in per]) for k in per[0]}
    ref = jax.vmap(lambda st: jax_fused_sync([st], [R.TRANSPORT_REDUCTIONS], "d", transport="int8", chunks=2)[0], axis_name="d")(stacked)
    for r, res in enumerate(results):
        assert np.array_equal(res["int8"]["s"].view(np.uint32), np.asarray(ref["s"])[r].view(np.uint32))
        np.testing.assert_array_equal(res["int8"]["c"], np.asarray(ref["c"])[r])
        np.testing.assert_allclose(res["int8"]["m"], np.asarray(ref["m"])[r], rtol=MEAN_RTOL)
        gathers = [c for c in res["int8_calls"] if c[0] == "all_gather"]
        assert len(gathers) == 1 and len(_all_reduces(res["int8_calls"])) == 4

