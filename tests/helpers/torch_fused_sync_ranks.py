"""The ranks of ``tests/test_torch_fused_sync.py``: one Gloo process each,
importing torch, numpy and the port only (neither JAX nor ``metrics_tpu``).

Every rank runs every check once and puts its numbers on a queue; the test
holds them against the JAX package in the parent process. The data of each
check is made from a seed with numpy by :func:`shards`, the same on every
rank and in the parent.
"""
import sys
import traceback
import warnings

import numpy as np

C = 4  # the registry collections' class count
SEED = 11
ROWS = {2: [40, 27], 4: [24, 9, 31, 16]}  # rows per rank: ragged
SKETCH_ROWS = {2: [700, 450], 4: [400, 250, 333, 517]}
SKETCH_GEOMETRY = dict(eps=0.05, max_items=1 << 14)  # a small quantile sketch: several levels
CM_WIDTH = 256
FAULT_SHARE = 0.1
F3_SHAPE = (4, 5)  # rank 0's one batch of multidim labels; the other ranks have none


def shards(kind, world):
    """The data of one check, split over ``world`` ranks: a list of
    per-rank tuples of numpy arrays."""
    sketch = kind in ("sketch", "sketch_nan")
    rng = np.random.default_rng(SEED + {"stat": 0, "guarded": 1, "sketch": 2, "curve": 3, "sketch_nan": 4}[kind])
    sizes = SKETCH_ROWS[world] if sketch else ROWS[world]
    n = sum(sizes)
    if sketch:
        x = rng.lognormal(0.0, 1.0, n).astype(np.float32)
        pick = rng.random(n)
        x[pick < FAULT_SHARE / 3] = np.nan
        x[(pick >= FAULT_SHARE / 3) & (pick < 2 * FAULT_SHARE / 3)] = np.inf
        x[(pick >= 2 * FAULT_SHARE / 3) & (pick < FAULT_SHARE)] = -np.inf
        if kind == "sketch_nan":  # NaN rows only, so the mean is finite
            x[np.isinf(x)] = np.nan
        cols = (x,)
    elif kind == "curve":
        cols = (rng.random(n).astype(np.float32), (rng.random(n) < 0.4).astype(np.int32))
    else:
        p = rng.random((n, C)).astype(np.float32)
        t = rng.integers(0, C, n).astype(np.int64)
        if kind == "guarded":
            pick = rng.random(n)
            p[pick < FAULT_SHARE / 2] = np.nan
            t[(pick >= FAULT_SHARE / 2) & (pick < FAULT_SHARE)] = C
        cols = (p, t)
    bounds = np.cumsum([0] + sizes)
    return [tuple(c[a:b] for c in cols) for a, b in zip(bounds[:-1], bounds[1:])]


TRANSPORT_REDUCTIONS = {"s": "sum", "c": "sum", "m": "mean"}


def transport_states(rank):
    """A rank's states for the quantized transport over Gloo: a float32 sum
    leaf over four decades, an int32 sum leaf and a float32 mean leaf."""
    rng = np.random.default_rng(SEED + 50 + rank)
    return {
        "s": (rng.standard_normal(700) * 10.0 ** rng.uniform(-2, 2, 700)).astype(np.float32),
        "c": rng.integers(0, 99, 5).astype(np.int32),
        "m": rng.random(33).astype(np.float32),
    }


def batches(rows):
    """Two batches of a rank's rows (the first through ``forward``); none
    for an empty rank."""
    n = rows[0].shape[0]
    half = (n + 1) // 2
    return [tuple(c[a:b] for c in rows) for a, b in ((0, half), (half, n)) if b > a]


def stat_collection(pkg, **kw):
    """The registry's ``fused_stat_collection``."""
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=C, **kw),
        "prec": pkg.Precision(num_classes=C, average="macro", **kw),
        "rec": pkg.Recall(num_classes=C, average="macro", **kw),
        "f1": pkg.F1Score(num_classes=C, average="macro", **kw),
    })


def guarded_collection(pkg, **kw):
    """The registry's ``guarded_collection``."""
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=C, on_invalid="warn", **kw),
        "f1": pkg.F1Score(num_classes=C, average="macro", on_invalid="warn", **kw),
    })


def sketch_collection(pkg, **kw):
    """The registry's ``sketch_guarded_collection``."""
    return pkg.MetricCollection({
        "mean": pkg.MeanMetric(nan_strategy="warn", **kw),
        "q": pkg.QuantileSketch(on_invalid="drop", quantiles=(0.5, 0.99), **SKETCH_GEOMETRY, **kw),
        "cm": pkg.CountMinSketch(width=CM_WIDTH, **kw),
    })


class Recorder:
    """Counts the collectives made through ``torch.distributed``."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce_scatter", "gather")

    def __init__(self, dist):
        self.dist = dist
        self.calls = []
        self._saved = {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.dist, name)
            self._saved[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                tensor = args[0] if args else None
                if _name == "all_reduce" and tensor is not None:
                    self.calls.append((_name, str(tensor.dtype).replace("torch.", ""), str(kwargs.get("op", args[1] if len(args) > 1 else "SUM"))))
                else:
                    self.calls.append((_name,))
                return _fn(*args, **kwargs)

            setattr(self.dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.dist, name, fn)


def _numpy(value):
    import torch

    if isinstance(value, dict):
        return {k: _numpy(v) for k, v in value.items()}
    if hasattr(value, "_fields"):  # a sketch state, a ring, the fault counters
        return {f: _numpy(v) for f, v in zip(value._fields, value)}
    if isinstance(value, (list, tuple)):
        return [_numpy(v) for v in value]
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def _feed(coll, rows, torch):
    for i, batch in enumerate(batches(rows)):
        args = [torch.from_numpy(np.ascontiguousarray(c)) for c in batch]
        if i == 0:
            coll(*args)
        else:
            coll.update(*args)


def _states(coll):
    return {name: _numpy(m.metric_state) for name, m in coll.items(keep_base=True, copy_state=False)}


def _run_collection(coll, rows, torch, dist, out, key):
    """Feed, compute under a recorder, sync the states once more, and check
    that the members point at their head's local state afterwards."""
    with Recorder(dist) as fwd:
        _feed(coll, rows, torch)
    local = _states(coll)
    with Recorder(dist) as rec:
        values = coll.compute()
    out[key] = {
        "forward_calls": fwd.calls,
        "compute_calls": rec.calls,
        "values": _numpy(values),
        "local": local,
        "groups": [list(g) for g in coll.compute_groups.values()],
        "after_compute": _states(coll),
        "faults": {name: m.fault_counts for name, m in coll.items(keep_base=True, copy_state=False)},
    }
    # every member reads its own local state again: an update after the
    # synced compute reaches the head and every member of its group
    if rows[0].shape[0]:
        coll.update(*[torch.from_numpy(np.ascontiguousarray(c[:3])) for c in rows])
        out[key]["after_update"] = _states(coll)
    coll.sync_states()
    out[key]["synced"] = _states(coll)


def rank_main(rank, world, store, queue):
    try:
        import torch
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.parallel.sync import _pad_gather_trim, fused_sync

        out = {}
        _run_collection(stat_collection(mtt, device="cpu"), shards("stat", world)[rank], torch, dist, out, "stat")
        _run_collection(guarded_collection(mtt, device="cpu"), shards("guarded", world)[rank], torch, dist, out, "guarded")
        _run_collection(sketch_collection(mtt, device="cpu"), shards("sketch", world)[rank], torch, dist, out, "sketch")
        _run_collection(sketch_collection(mtt, device="cpu"), shards("sketch_nan", world)[rank], torch, dist, out, "sketch_nan")

        # list states of a compute group: gathered once when every rank has
        # formed the group
        curve = mtt.MetricCollection({"auroc": mtt.AUROC(device="cpu"), "ap": mtt.AveragePrecision(device="cpu")})
        _run_collection(curve, shards("curve", world)[rank], torch, dist, out, "curve")

        # F3: a samplewise list state, and only rank 0 has a batch
        f3 = {}
        for name, metric in (
            ("precision", mtt.Precision(num_classes=3, average="macro", mdmc_average="samplewise", device="cpu")),
            ("stat_scores", mtt.StatScores(reduce="macro", num_classes=3, mdmc_reduce="samplewise", device="cpu")),
            ("micro", mtt.Recall(num_classes=3, average="micro", mdmc_average="samplewise", device="cpu")),
        ):
            if rank == 0:
                rng = np.random.default_rng(SEED + 5)
                metric.update(torch.from_numpy(rng.integers(0, 3, F3_SHAPE)), torch.from_numpy(rng.integers(0, 3, F3_SHAPE)))
            f3[name] = _numpy(metric.compute())
        out["f3"] = f3

        # the ragged gather: an empty rank of another dtype and number of
        # dimensions joins the others; ranks with rows that disagree raise
        # on every rank, before any payload
        local = torch.zeros((0,), dtype=torch.float32) if rank == world - 1 else torch.full((rank + 1, 3), rank, dtype=torch.int32)
        out["ragged"] = _numpy(_pad_gather_trim(local))
        try:
            _pad_gather_trim(torch.ones(2, dtype=torch.int32 if rank % 2 else torch.float32))
            out["mismatch"] = None
        except ValueError as err:
            out["mismatch"] = str(err)
        # int16, which neither Gloo nor NCCL carries, travels as bytes: a
        # ragged gather and a list state through fused_sync
        local16 = (torch.arange(3 * (rank + 1), dtype=torch.int16) * 1000 - 9).reshape(-1, 3)
        out["int16"] = _numpy(_pad_gather_trim(local16))
        out["int16_list"] = _numpy(fused_sync([{"v": [local16]}], [{"v": "cat"}], defaults=[{"v": torch.zeros((0, 3), dtype=torch.int16)}])[0]["v"])
        # the int8 transport, chunked, through the default (bounded) communicator
        states = {k: torch.from_numpy(v) for k, v in transport_states(rank).items()}
        with Recorder(dist) as rec:
            out["int8"] = _numpy(fused_sync([states], [TRANSPORT_REDUCTIONS], transport="int8", chunks=2)[0])
        out["int8_calls"] = rec.calls
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # the parent re-raises it with the rank's traceback
        queue.put((rank, {"error": traceback.format_exc()}))
