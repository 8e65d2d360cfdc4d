"""The port's multi-process path on the CPU: Gloo worlds of 2 and 4 spawned
processes, one per world, each running every check below once.

- ``compute()`` in a world of W ranks equals the port in one process over
  the concatenated rows: curves exactly, areas within ``AREA_ATOL``;
- ragged and empty ranks go through ``_pad_gather_trim`` (a list state of
  an empty rank gathers its ``template``);
- a ``CatBuffer``'s ``dropped`` count sums across ranks;
- ``sharded_descending_ranks`` is bit-equal to the stable descending ranks
  of the gathered scores whenever ``resolved``, is a permutation of the
  global rows otherwise, and makes exactly two collectives per call
  (counted by a recording wrapper around ``torch.distributed``'s
  ``all_reduce`` and ``all_gather``).

The JAX package's sharded path cannot run on this machine's jax (ROADMAP
F0), so the ranks are held against the in-process gathered sort. The ranks
import neither JAX nor ``metrics_tpu``; this module does not either.
"""
import sys
import traceback
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch.ops.bucketed_rank import ascending_ranks, sharded_descending_ranks  # noqa: E402
from metrics_tpu_torch.parallel.sync import _pad_gather_trim, distributed_available, gather_all_arrays  # noqa: E402
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer  # noqa: E402
from tests.helpers.torch_twin_world import TwinWorld  # noqa: E402

AREA_ATOL = 1e-6  # float32 sums over a curve, added in another order
SEED = 7
# rows per rank: ragged, and in the four-rank world one rank holds none
SIZES = {2: [230, 71], 4: [150, 0, 93, 61]}
NONEMPTY = {2: [230, 71], 4: [150, 1, 93, 61]}  # for the metrics that need a batch on every rank
CAP = 512
SMALL_CAP = 64
NUM_BUCKETS = 64
GRID = 64  # the quantized scores' grid, one point per bucket: floor(s * GRID) / GRID


def _rows(sizes, seed):
    n = sum(sizes)
    rng = np.random.default_rng(seed)
    p = rng.random(n).astype(np.float32)
    tie = rng.random(n) < 0.3
    p[tie] = np.round(p[tie], 1)
    y = (rng.random(n) < 0.4).astype(np.int32)
    bounds = np.cumsum([0] + list(sizes))
    return p, y, [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _rank_scores(sizes, seed):
    """Per-rank scores for the sharded ranks: quantized, continuous,
    all-equal, and with ±inf, NaN and a ``valid`` mask."""
    n = sum(sizes)
    rng = np.random.default_rng(seed)
    quantized = (np.floor(rng.random(n) * GRID) / GRID).astype(np.float32)
    special = quantized.copy()
    pick = rng.random(n)
    special[pick < 0.05] = np.inf
    special[(pick >= 0.05) & (pick < 0.08)] = -np.inf
    special[(pick >= 0.08) & (pick < 0.1)] = np.nan
    return {
        "quantized": quantized,
        "continuous": rng.normal(size=n).astype(np.float32),
        "equal": np.full(n, 0.5, np.float32),
        "special_masked": special,
    }, rng.random(n) < 0.85


def _curve_collection(cap=CAP):
    return mtt.MetricCollection({
        "auroc": mtt.AUROC(device="cpu"),
        "ap": mtt.AveragePrecision(device="cpu"),
        "auroc_ring": mtt.AUROC(capacity=cap, device="cpu"),
        "ap_ring": mtt.AveragePrecision(capacity=cap, device="cpu"),
        "acc": mtt.Accuracy(device="cpu"),
    })


def _empty_rank_collection(cap=CAP):
    return mtt.MetricCollection({
        "roc": mtt.ROC(num_classes=1, device="cpu"),
        "prc": mtt.PrecisionRecallCurve(num_classes=1, device="cpu"),
        "roc_ring": mtt.ROC(capacity=cap, device="cpu"),
        "auc": mtt.AUC(reorder=True, device="cpu"),
    })


def _feed(coll, p, y):
    """Two batches, the first through forward; nothing for an empty shard."""
    half = (p.shape[0] + 1) // 2
    for i, (a, b) in enumerate([(0, half), (half, p.shape[0])]):
        if b <= a:
            continue
        args = (torch.from_numpy(p[a:b]), torch.from_numpy(y[a:b]))
        if i == 0:
            coll(*args)
        else:
            coll.update(*args)


def _numpy(value):
    if isinstance(value, dict):
        return {k: _numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_numpy(v) for v in value]
    return value.numpy()


class _Recorder:
    """Counts the collectives made through ``torch.distributed``."""

    def __init__(self):
        self.calls = []
        self._saved = {}

    def __enter__(self):
        for name in ("all_reduce", "all_gather"):
            fn = getattr(dist, name)
            self._saved[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                self.calls.append(_name)
                return _fn(*args, **kwargs)

            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _rank_main(rank, world, store, queue):
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        out = {"available": distributed_available()}
        warnings.simplefilter("ignore")

        p, y, bounds = _rows(NONEMPTY[world], SEED)
        a, b = bounds[rank]
        coll = _curve_collection()
        _feed(coll, p[a:b], y[a:b])
        out["curves"] = _numpy(coll.compute())

        p, y, bounds = _rows(SIZES[world], SEED + 1)
        a, b = bounds[rank]
        coll = _empty_rank_collection()
        _feed(coll, p[a:b], y[a:b])
        out["empty_rank"] = _numpy(coll.compute())

        # a small ring: rank 0 overflows, the others need not
        ring = mtt.AUROC(capacity=SMALL_CAP, on_overflow="ignore", device="cpu")
        ring.update(torch.from_numpy(p[a:b]), torch.from_numpy(y[a:b]))
        out["local_dropped"] = ring.dropped_count
        ring.sync()
        out["synced_dropped"] = ring.dropped_count
        out["synced_capacity"] = ring.metric_state["preds"].capacity
        ring.unsync()
        out["unsynced_dropped"] = ring.dropped_count
        out["small_ring_auroc"] = float(ring.compute())

        # ragged gathers straight through the transport
        local = torch.arange(rank * 3 * 2, dtype=torch.int64).reshape(rank * 3, 2)
        out["ragged"] = _numpy(gather_all_arrays(local))
        out["ragged_bool"] = _numpy(_pad_gather_trim(torch.ones(rank, dtype=torch.bool)))
        out["scalar"] = _numpy(gather_all_arrays(torch.tensor(float(rank))))

        sizes = SIZES[world]
        scores, valid = _rank_scores(sizes, SEED + 2)
        a, b = int(np.sum(sizes[:rank])), int(np.sum(sizes[:rank + 1]))
        out["ranks"] = {}
        for kind, s in scores.items():
            v = torch.from_numpy(valid[a:b]) if kind == "special_masked" else None
            with _Recorder() as rec:
                ranks, resolved = sharded_descending_ranks(torch.from_numpy(s[a:b]), num_buckets=NUM_BUCKETS, valid=v)
            out["ranks"][kind] = (ranks.numpy(), bool(resolved), list(rec.calls))
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # the parent re-raises it with the rank's traceback
        queue.put((rank, {"error": traceback.format_exc()}))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    """Spawn one Gloo world and collect every rank's results."""
    n = request.param
    store = tmp_path_factory.mktemp(f"gloo{n}") / "store"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n, str(store), queue)) for r in range(n)]
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


def _same(ours, ref, atol=0.0):
    if isinstance(ref, dict):
        assert set(ours) == set(ref)
        for k in ref:
            _same(ours[k], ref[k], atol)
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _same(a, b, atol)
    else:
        a, b = np.asarray(ours), np.asarray(ref)
        assert a.shape == b.shape
        if atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(a, b)


AREAS = {"auroc", "ap", "auroc_ring", "ap_ring", "auc"}


def _world_one(coll, p, y):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _feed(coll, p, y)
        return _numpy(coll.compute())


def test_ranks_see_a_world_and_import_no_jax(world):
    n, results = world
    assert all(res["available"] for res in results)
    assert all(res["jax_loaded"] == [] for res in results)


def test_curve_collection_equals_world_one(world):
    n, results = world
    p, y, _ = _rows(NONEMPTY[n], SEED)
    # a synced ring is the union of W rings: its padded curves have the
    # shape of one ring of W times the capacity
    ref = _world_one(_curve_collection(n * CAP), p, y)
    for res in results:
        for key, value in ref.items():
            _same(res["curves"][key], value, AREA_ATOL if key in AREAS else 0.0)
        # every rank reads the same value, bit for bit
        _same(res["curves"], results[0]["curves"])


def test_empty_rank_goes_through_the_ragged_gather(world):
    n, results = world
    p, y, _ = _rows(SIZES[n], SEED + 1)
    ref = _world_one(_empty_rank_collection(n * CAP), p, y)
    for res in results:
        for key, value in ref.items():
            _same(res["empty_rank"][key], value, AREA_ATOL if key in AREAS else 0.0)


def test_ring_dropped_sums_across_ranks(world):
    n, results = world
    sizes = SIZES[n]
    local = [max(0, s - SMALL_CAP) for s in sizes]
    p, y, bounds = _rows(sizes, SEED + 1)
    kept = np.concatenate([np.arange(a, min(b, a + SMALL_CAP)) for a, b in bounds])
    ref = mtt.AUROC(capacity=n * SMALL_CAP, device="cpu")
    ref.update(torch.from_numpy(p[kept]), torch.from_numpy(y[kept]))
    for r, res in enumerate(results):
        assert res["local_dropped"] == local[r] == res["unsynced_dropped"]
        assert res["synced_dropped"] == sum(local) > 0
        assert res["synced_capacity"] == n * SMALL_CAP
        assert abs(res["small_ring_auroc"] - float(ref.compute())) <= AREA_ATOL


def test_pad_gather_trim_ragged_shapes(world):
    n, results = world
    for res in results:
        assert [a.shape for a in res["ragged"]] == [(r * 3, 2) for r in range(n)]
        for r, a in enumerate(res["ragged"]):
            np.testing.assert_array_equal(a, np.arange(r * 6).reshape(r * 3, 2))
        assert [a.tolist() for a in res["ragged_bool"]] == [[True] * r for r in range(n)]
        assert [float(a) for a in res["scalar"]] == [float(r) for r in range(n)]


@pytest.mark.parametrize("kind", ["quantized", "continuous", "equal", "special_masked"])
def test_sharded_ranks_against_the_gathered_sort(world, kind):
    n, results = world
    sizes = SIZES[n]
    scores, valid = _rank_scores(sizes, SEED + 2)
    s = scores[kind]
    v = valid if kind == "special_masked" else np.ones(s.shape[0], bool)
    # the stable descending ranks of the gathered scores, left-out rows last
    want = ascending_ranks(-torch.from_numpy(np.where(v, s, np.nan).astype(np.float32))).numpy()
    got = np.concatenate([res["ranks"][kind][0] for res in results])
    resolved = {res["ranks"][kind][1] for res in results}
    assert len(resolved) == 1
    np.testing.assert_array_equal(np.sort(got), np.arange(s.shape[0]))
    if kind == "continuous":
        # a 64-bucket grid over normal scores: buckets collide
        assert resolved == {False}
    else:
        assert resolved == {True}
        np.testing.assert_array_equal(got, want)
    if kind == "equal":
        assert int(got.astype(np.int64).sum()) == s.shape[0] * (s.shape[0] - 1) // 2
    for res in results:
        assert res["ranks"][kind][2] == ["all_reduce", "all_gather"]


def test_sharded_ranks_in_a_world_of_one_match_the_sort():
    scores, _ = _rank_scores([500], SEED + 3)
    s = torch.from_numpy(scores["quantized"])
    with _Recorder() as rec:
        ranks, resolved = sharded_descending_ranks(s, num_buckets=NUM_BUCKETS)
    assert bool(resolved) and rec.calls == []
    np.testing.assert_array_equal(ranks.numpy(), ascending_ranks(-s).numpy())


def test_sync_jobs_with_an_injected_transport():
    """``dist_sync_fn`` replaces the communicator: a fake two-rank world
    whose other rank holds the same states. List states double, rings stack
    with their drops summed, sum states double and max states stay."""
    p, y, _ = _rows([40], SEED)
    m = mtt.AUROC(device="cpu")
    m.update(torch.from_numpy(p), torch.from_numpy(y))
    twice = TwinWorld()
    m.sync(dist_sync_fn=twice, distributed_available_fn=lambda: True)
    assert torch.equal(torch.cat(m.preds), torch.cat([torch.from_numpy(p)] * 2))
    m.unsync()
    assert torch.equal(torch.cat(m.preds), torch.from_numpy(p))

    ring = mtt.AUROC(capacity=32, on_overflow="ignore", device="cpu")
    ring.update(torch.from_numpy(p), torch.from_numpy(y))
    with ring.sync_context(dist_sync_fn=twice, distributed_available_fn=lambda: True):
        state = ring.metric_state["preds"]
        assert isinstance(state, CatBuffer) and state.capacity == 64 and int(state.dropped) == 16
    assert ring.metric_state["preds"].capacity == 32

    acc = mtt.Accuracy(device="cpu")
    acc.update(torch.from_numpy(p), torch.from_numpy(y))
    before = {k: v.clone() for k, v in acc.metric_state.items()}
    acc.sync(dist_sync_fn=twice, distributed_available_fn=lambda: True)
    for key, value in acc.metric_state.items():
        assert torch.equal(value, 2 * before[key])
    with pytest.raises(Exception, match="already been synced"):
        acc.sync(dist_sync_fn=twice, distributed_available_fn=lambda: True)
    acc.unsync()
    with pytest.raises(Exception, match="already been un-synced"):
        acc.unsync()


def test_no_world_means_local_values():
    assert not distributed_available()
    x = torch.arange(3)
    assert gather_all_arrays(x)[0] is x
    m = mtt.AveragePrecision(device="cpu")
    p, y, _ = _rows([30], SEED)
    m.update(torch.from_numpy(p), torch.from_numpy(y))
    m.compute()
    assert not m._is_synced
