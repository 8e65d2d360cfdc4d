"""The ranks of the four-process check of the pure layer in
``tests/test_torch_pure.py``: one Gloo process each, importing torch, numpy
and the port only (neither JAX nor ``metrics_tpu``).

Each rank folds its shard of two seeded streams into pure states (ragged
shards) and computes them over ``torch.distributed.group.WORLD`` under a
recorder of the collectives:

- a classification collection (guarded members and a ``ClasswiseWrapper``)
  through ``functionalize(coll, group=WORLD)``: ``compute`` and ``faults``;
  then through ``overlapped_functionalize``: ``cycle``, ``read`` and
  ``read_fresh``;
- a regression collection (Pearson's stacked moments, Spearman's rings,
  R2, MSE) through ``functionalize``;
- ``bootstrap_functionalize(metric, b, group=WORLD)`` at two replica
  counts, on indices drawn with numpy (``compute``, ``faults`` and
  ``dropped``), of a metric of each state kind that JAX's batched sync
  takes: a guarded ``Accuracy`` (sums and fault counters),
  ``PearsonCorrCoef`` (``None``-reduced moments), ``SpearmanCorrCoef`` and
  ``AUROC`` with rings (Spearman's overflowing), a ``QuantileSketch``, a
  ``HyperLogLog``, a ``CountMinSketch`` and a metric with a callable
  reduction; and each one's ``functionalize(metric, group=WORLD)`` compute,
  whose collectives the bootstrap's must not outnumber.
"""
import sys
import traceback
import warnings

import numpy as np

from tests.helpers.torch_fused_sync_ranks import Recorder, _numpy

C = 5
SEED = 31
ROWS = [29, 6, 41, 17]  # rows per rank: ragged (an empty rank could not infer Accuracy's mode)
THRESHOLDS = 8
RING = 128  # Spearman's ring on each rank: its whole shard
BOOT_RING = 16  # the bootstrap's Spearman ring: smaller than a rank's shard, so it drops rows
BOOTSTRAPS = (3, 6)  # two replica counts: the collectives must not grow with them
SKETCHES = ("quantile", "hll", "countmin")  # the bootstraps whose synced states are held bit for bit


def class_shards(world):
    """Scores and labels, 10 % of the rows with a NaN score or the label
    ``C``, split over the ranks."""
    rng = np.random.default_rng(SEED)
    n = sum(ROWS[:world])
    p = rng.random((n, C)).astype(np.float32)
    t = rng.integers(0, C, n).astype(np.int64)
    pick = rng.random(n)
    p[pick < 0.05, 1] = np.nan
    t[(pick >= 0.05) & (pick < 0.1)] = C
    bounds = np.cumsum([0] + ROWS[:world])
    return [(p[a:b], t[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def reg_shards(world):
    """Ratings on a half-star grid and noisy predictions, split over the ranks."""
    rng = np.random.default_rng(SEED + 1)
    n = sum(ROWS[:world])
    t = (rng.integers(1, 11, n) / 2).astype(np.float32)
    p = np.clip(t + rng.normal(scale=0.8, size=n), 0.5, 5.0).astype(np.float32)
    bounds = np.cumsum([0] + ROWS[:world])
    return [(p[a:b], t[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def binary_shards(world):
    """Binary scores on a grid of 64 (ties) and labels, positives scoring
    higher on average, split over the ranks."""
    rng = np.random.default_rng(SEED + 2)
    n = sum(ROWS[:world])
    t = (rng.random(n) < 0.4).astype(np.int64)
    p = (np.floor(np.clip(rng.normal(0.4 + 0.2 * t, 0.2), 0.0, 0.999) * 64) / 64).astype(np.float32)
    bounds = np.cumsum([0] + ROWS[:world])
    return [(p[a:b], t[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def value_shards(world):
    """Lognormal values, a stream sketch's one column: 24 rows a rank, so
    that every batch has one shape (the sketches' payloads do not depend on
    the rows)."""
    rng = np.random.default_rng(SEED + 3)
    return [(rng.lognormal(0.0, 1.0, 24).astype(np.float32),) for _ in range(world)]


def rank_weighted(rows):
    """A callable reduction that tells the ranks apart: rank 0's row once,
    every other rank's twice."""
    return rows[0] + 2 * rows[1:].sum(0)


def weighted_total(pkg, **kw):
    """A metric whose state has a callable ``dist_reduce_fx``, written once
    over either package's ``Metric``: the sum of its scores times their
    targets."""

    class WeightedTotal(pkg.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", default=np.zeros((), np.float32), dist_reduce_fx=rank_weighted)

        def update(self, preds, target):
            self.total = self.total + (preds * target).sum()

        def compute(self):
            return self.total

    return WeightedTotal(**kw)


def class_collection(pkg, **kw):
    drop = dict(num_classes=C, on_invalid="drop", **kw)
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(**drop),
        "prec": pkg.Precision(average="macro", **drop),
        # the binned counters boolean-index under "drop": "warn" counts only
        "bap": pkg.BinnedAveragePrecision(num_classes=C, thresholds=THRESHOLDS, on_invalid="warn", **kw),
        "per_class": pkg.ClasswiseWrapper(pkg.Recall(average=None, **drop)),
    })


def reg_collection(pkg, **kw):
    return pkg.MetricCollection({
        "pearson": pkg.PearsonCorrCoef(**kw),
        "spearman": pkg.SpearmanCorrCoef(capacity=RING, **kw),
        "r2": pkg.R2Score(**kw),
        "mse": pkg.MeanSquaredError(**kw),
    })


def boot_metrics(pkg, **kw):
    """``{name: (metric, shards)}`` of the bootstrap check: sum states with
    the fault counters, ``None``-reduced (stacked) moments, rings, quantile,
    distinct-count and frequency sketches, and a callable reduction."""
    return {
        "acc": (pkg.Accuracy(num_classes=C, on_invalid="drop", **kw), class_shards),
        "pearson": (pkg.PearsonCorrCoef(**kw), reg_shards),
        "spearman": (pkg.SpearmanCorrCoef(capacity=BOOT_RING, **kw), reg_shards),
        "auroc": (pkg.AUROC(capacity=RING, **kw), binary_shards),
        "quantile": (pkg.QuantileSketch(eps=0.05, **kw), value_shards),
        "hll": (pkg.HyperLogLog(**kw), value_shards),
        "countmin": (pkg.CountMinSketch(**kw), value_shards),
        "callable": (weighted_total(pkg, **kw), reg_shards),
    }


def boot_indices(rank, batch, b, n):
    """The ``(b, n)`` resampling indices of one batch of a rank."""
    return np.random.default_rng((SEED, rank, batch, b)).integers(0, n, (b, n))


def batches(rows):
    """Two batches of a rank's rows; none for an empty rank."""
    n = rows[0].shape[0]
    half = (n + 1) // 2
    return [tuple(c[a:b] for c in rows) for a, b in ((0, half), (half, n)) if b > a]


def fold(update, state, rows, torch):
    for batch in batches(rows):
        state = update(state, *(torch.from_numpy(np.ascontiguousarray(c)) for c in batch))
    return state


def rank_main(rank, world, store, queue):
    try:
        import torch
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.parallel.sync import fused_sync

        group = dist.group.WORLD
        out = {}
        cdef = mtt.functionalize(class_collection(mtt, device="cpu"), group=group)
        state = fold(cdef.update, cdef.init(), class_shards(world)[rank], torch)
        with Recorder(dist) as rec:
            values = cdef.compute(state)
        out["class_values"], out["class_calls"] = _numpy(values), rec.calls
        with Recorder(dist) as rec:
            faults = cdef.faults(state)
        out["faults"], out["faults_calls"] = _numpy(faults), rec.calls
        out["local_state"] = _numpy(state)

        odef = mtt.overlapped_functionalize(class_collection(mtt, device="cpu"), group=group)
        ostate = fold(odef.update, odef.init(), class_shards(world)[rank], torch)
        with Recorder(dist) as rec:
            ostate = odef.cycle(ostate)
        out["cycle_calls"] = rec.calls
        with Recorder(dist) as rec:
            read = odef.read(ostate)
            lag = odef.lag(ostate)
        out["read_calls"], out["read"], out["lag"] = rec.calls, _numpy(read), int(lag)
        out["read_fresh"] = _numpy(odef.read_fresh(ostate))

        rdef = mtt.functionalize(reg_collection(mtt, device="cpu"), group=group)
        rstate = fold(rdef.update, rdef.init(), reg_shards(world)[rank], torch)
        with Recorder(dist) as rec:
            out["reg_values"] = _numpy(rdef.compute(rstate))
        out["reg_calls"] = rec.calls

        for b in BOOTSTRAPS:
            for name, (metric, shards) in boot_metrics(mtt, device="cpu").items():
                bdef = mtt.bootstrap_functionalize(metric, b, group=group)
                bstate = bdef.init()
                for j, batch in enumerate(batches(shards(world)[rank])):
                    idx = torch.from_numpy(boot_indices(rank, j, b, batch[0].shape[0]))
                    bstate = bdef.update.with_indices(bstate, idx, *(torch.from_numpy(np.ascontiguousarray(c)) for c in batch))
                key = f"boot_{name}_{b}"
                for fn in ("compute", "faults", "dropped"):
                    with Recorder(dist) as rec:
                        out[f"{key}_{fn}"] = _numpy(getattr(bdef, fn)(bstate))
                    out[f"{key}_{fn}_calls"] = rec.calls
                out[f"{key}_local_state"] = _numpy(bstate)
                if name in SKETCHES and b == BOOTSTRAPS[0]:  # the synced stacked state itself
                    synced = fused_sync([bstate], [dict(metric._reductions)], group, lanes=b)[0]
                    out[f"{key}_synced"] = _numpy(synced)
        for name, (metric, shards) in boot_metrics(mtt, device="cpu").items():
            mdef = mtt.functionalize(metric, group=group)
            state = fold(mdef.update, mdef.init(), shards(world)[rank], torch)
            with Recorder(dist) as rec:
                mdef.compute(state)
            out[f"single_{name}_compute_calls"] = rec.calls
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # the parent re-raises it with the rank's traceback
        queue.put((rank, {"error": traceback.format_exc()}))
