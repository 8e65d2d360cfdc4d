"""The ranks of the four-process check of sharded slices in
``tests/test_torch_sliced.py``: one Gloo process each, importing torch,
numpy and the port only (neither JAX nor ``metrics_tpu``).

Each rank folds its shard of a seeded stream (ragged shards, slice ids
with some out of range) into ``sliced_functionalize(metric, K,
shard_slices=WORLD)`` states for every metric of :func:`metrics`, then
computes (the owned slices and the rollup) and reads the fault counts,
under a recorder of the collectives.
"""
import sys
import traceback
import warnings

import numpy as np

from tests.helpers.torch_fused_sync_ranks import Recorder, _numpy

C = 4
K = 8
SEED = 41
ROWS = [19, 7, 26, 12]


def shards(world):
    """Scores, labels and slice ids per rank: 10 % of the rows with a NaN
    score, ids in ``[-1, K + 1]``."""
    rng = np.random.default_rng(SEED)
    n = sum(ROWS[:world])
    p = rng.random((n, C)).astype(np.float32)
    t = rng.integers(0, C, n).astype(np.int64)
    ids = rng.integers(-1, K + 2, n).astype(np.int64)
    p[rng.random(n) < 0.1, 2] = np.nan
    bounds = np.cumsum([0] + ROWS[:world])
    return [(p[a:b], t[a:b], ids[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def metrics(pkg, **kw):
    """``{name: (metric, row -> update args)}``: a guarded accuracy (sum
    rings and the fault ring) and a max metric (a max ring)."""
    return {
        "acc": (pkg.Accuracy(num_classes=C, on_invalid="drop", **kw), lambda p, t: (p, t)),
        "max": (pkg.MaxMetric(**kw), lambda p, t: (np.nan_to_num(p[:, 0], nan=0.5),)),
    }


def rank_main(rank, world, store, queue):
    try:
        import torch
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt

        group = dist.group.WORLD
        p, t, ids = shards(world)[rank]
        out = {}
        for name, (metric, args) in metrics(mtt, device="cpu").items():
            sdef = mtt.sliced_functionalize(metric, K, shard_slices=group)
            state = sdef.update(sdef.init(), *(torch.from_numpy(np.ascontiguousarray(a)) for a in args(p, t)),
                                slice_ids=torch.from_numpy(ids))
            with Recorder(dist) as rec:
                value = sdef.compute(state)
            with Recorder(dist) as frec:
                faults = sdef.faults(state)
            out[name] = {"value": _numpy(dict(value)), "calls": rec.calls, "faults": _numpy(faults), "faults_calls": frec.calls}
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
