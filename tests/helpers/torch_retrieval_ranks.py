"""Seeded retrieval queries for ``tests/test_torch_retrieval.py``, and the
ranks of its four-process check: one Gloo process each, importing torch,
numpy and the port only (neither JAX nor ``metrics_tpu``).

:func:`queries` draws ``NUM_QUERIES`` ragged queries of 1-70 documents in
shuffled row order: N(0, 1) scores, a third of them rounded to one decimal
(ties), one ``-0.0``, one denormal and one ``-inf``; 0/1 targets (graded
0-3 for nDCG), with queries that hold no relevant document and queries
that hold only relevant ones.

Each rank takes the rows in chunks of ``CHUNK``, dealt round-robin (so a
query's documents sit on several ranks), updates every metric of
``WORLD_METRICS`` in the list mode and in the capacity mode, and computes
under a recorder of the collectives.
"""
import sys
import traceback
import warnings

import numpy as np

from tests.helpers.torch_fused_sync_ranks import Recorder

NUM_QUERIES = 40
MAX_DOCS = 70
WORLD_SEED = 21
CHUNK = 16
RING_GATHERS = 12  # per capacity-mode metric: data and mask of its three rings, a header and a payload each
WORLD_METRICS = [
    ("RetrievalMRR", {}),
    ("RetrievalMAP", {}),
    ("RetrievalNormalizedDCG", {"k": 10}),
    ("RetrievalPrecision", {"k": 10}),
]


def queries(seed, graded=False):
    """``(indexes int64, preds float32, target int64)`` rows of the
    seeded queries."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, MAX_DOCS + 1, NUM_QUERIES)
    idx = np.repeat(np.arange(NUM_QUERIES), counts)
    n = idx.shape[0]
    p = rng.normal(size=n).astype(np.float32)
    ties = rng.random(n) < 0.33
    p[ties] = np.round(p[ties], 1)
    p[rng.integers(0, n, 3)] = np.array([-0.0, 1e-40, -np.inf], np.float32)
    if graded:
        t = np.where(rng.random(n) < 0.3, rng.integers(1, 4, n), 0)
    else:
        t = (rng.random(n) < 0.2).astype(np.int64)
    t[idx == 3] = 0  # no relevant document
    t[idx == 7] = 1  # only relevant ones
    order = rng.permutation(n)
    return idx[order], p[order], t[order].astype(np.int64)


def capacity_kw(rows):
    return dict(capacity=rows[0].shape[0], num_queries=NUM_QUERIES, max_docs_per_query=MAX_DOCS)


def shard(rows, rank, world):
    """The rows of ``rank``: chunks of ``CHUNK`` rows dealt round-robin."""
    n = rows[0].shape[0]
    take = np.concatenate([np.arange(s, min(s + CHUNK, n)) for s in range(rank * CHUNK, n, world * CHUNK)])
    return tuple(x[take] for x in rows)


def rank_main(rank, world, store, queue):
    try:
        import torch
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt

        rows = queries(WORLD_SEED)
        idx, p, t = (torch.from_numpy(np.ascontiguousarray(x)) for x in shard(rows, rank, world))
        out = {}
        for mode in ("list", "capacity"):
            extra = capacity_kw(rows) if mode == "capacity" else {}
            metrics = {name: getattr(mtt, name)(device="cpu", **kw, **extra) for name, kw in WORLD_METRICS}
            for m in metrics.values():
                m.update(p, t, indexes=idx)
            with Recorder(dist) as rec:
                values = {name: m.compute().numpy() for name, m in metrics.items()}
            out[mode] = {"values": values, "calls": rec.calls}
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
