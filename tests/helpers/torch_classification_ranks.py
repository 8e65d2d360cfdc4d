"""The ranks of the four-process classification check of
``tests/test_torch_compositional.py``: one Gloo process each, importing
torch, numpy and the port only (neither JAX nor ``metrics_tpu``).

Each rank feeds its shard of a seeded multi-class stream to a collection
that holds ``ConfusionMatrix``, ``CohenKappa`` (one compute group), an F1
built as metric arithmetic from macro ``Precision`` and ``Recall`` (a
``CompositionalMetric``) and a binned ``CalibrationError``, then computes
under a recorder of the collectives.
"""
import sys
import traceback
import warnings

import numpy as np

from tests.helpers.torch_fused_sync_ranks import Recorder, _numpy

C = 5
SEED = 23
ROWS = [37, 0, 51, 20]  # rows per rank: ragged, one rank empty


def shards(world):
    rng = np.random.default_rng(SEED)
    n = sum(ROWS[:world])
    logits = rng.normal(size=(n, C)).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    target = rng.integers(0, C, n)
    bounds = np.cumsum([0] + ROWS[:world])
    return [(probs[a:b], target[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def collection(mtt, **kw):
    p = mtt.Precision(num_classes=C, average="macro", **kw)
    r = mtt.Recall(num_classes=C, average="macro", **kw)
    return mtt.MetricCollection({
        "cm": mtt.ConfusionMatrix(C, **kw),
        "kappa": mtt.CohenKappa(C, **kw),
        "f1": 2 * p * r / (p + r),
        "ce": mtt.CalibrationError(n_bins=10, binned=True, **kw),
    })


def feed(coll, rows, torch):
    n = rows[0].shape[0]
    for a, b in ((0, n // 2), (n // 2, n)):
        if b > a:
            coll.update(*(torch.from_numpy(np.ascontiguousarray(c[a:b])) for c in rows))


def rank_main(rank, world, store, queue):
    try:
        import torch
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt

        coll = collection(mtt, device="cpu")
        feed(coll, shards(world)[rank], torch)
        with Recorder(dist) as rec:
            values = coll.compute()
        out = {
            "values": _numpy(values),
            "calls": rec.calls,
            "local_cm": _numpy(coll["cm"].metric_state["confmat"]),
            "jax_loaded": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu")),
        }
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # the parent re-raises it with the rank's traceback
        queue.put((rank, {"error": traceback.format_exc()}))
