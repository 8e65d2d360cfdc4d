"""The ranks of the witnessed run in ``tests/test_torch_lockwitness.py``: two
Gloo processes, started with ``METRICS_TPU_LOCKCHECK=1`` so that the port's
module-level locks are armed when it is imported, importing torch, numpy and
the port only (neither JAX nor ``metrics_tpu``).

Rank 0 serves a short stream, before the two join their world: a
``ServeLoop`` of two workers with tracing forced on, a drift monitor,
periodic snapshots, a flight recorder and a ``FleetPublisher`` to an
``Aggregator`` behind a ``FleetServer`` on 127.0.0.1. Then both ranks
update an overlapped-sync collection and read it (``compute()`` and
``compute(fresh=True)``). Each rank reports the witness's
findings and the order edges it observed.
"""
import os
import tempfile
import time
import traceback
import warnings

import numpy as np

C = 4
REQUESTS = 32
SYNC_BATCHES = 6


def requests(seed):
    """Ragged requests of (scores, labels): 1-12 rows of ``C`` classes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(REQUESTS):
        n = int(rng.integers(1, 13))
        p = rng.random((n, C)).astype(np.float32)
        out.append((p / p.sum(1, keepdims=True), rng.integers(0, C, n).astype(np.int64)))
    return out


def _confidence(args, kwargs):
    return args[0].max(dim=-1).values


def served_stream(mtt, dev, directory):
    """The served stream of rank 0; returns its counts."""
    import torch

    from metrics_tpu_torch import fleet
    from metrics_tpu_torch.obs import flightrec
    from metrics_tpu_torch.obs import trace as tr

    rec = flightrec.FlightRecorder(os.path.join(directory, "flightrec"), min_interval_s=0.0)
    flightrec.install_flight_recorder(rec)
    mgr = mtt.SnapshotManager(os.path.join(directory, "snapshots"), tag="witnessed")
    monitor = mtt.DriftMonitor("conf", window=256, eps=0.05, device=dev, extract=_confidence)
    agg = fleet.Aggregator(mtt.Accuracy(num_classes=C, on_invalid="drop", device=dev), "pod")
    server = fleet.FleetServer(agg)
    try:
        with tr.force_tracing(True):
            loop = mtt.ServeLoop(mtt.Accuracy(num_classes=C, on_invalid="drop", device=dev), workers=2, reduce_every_s=0.05,
                                 snapshot_manager=mgr, snapshot_every_s=0.1, drift_monitors=[monitor])
            pub = fleet.FleetPublisher(loop, server.channel(), host_id="host-0", publish_every_s=0.05)
            try:
                for p, y in requests(0):
                    loop.offer(torch.from_numpy(p), torch.from_numpy(y))
                assert loop.drain(60), "the loop did not drain"
                view = loop.report(fresh=True, deadline_s=60)
                # a publish of the final view (one of the cadence's may still be in flight)
                deadline = time.monotonic() + 30
                while (answers := pub.publish_now())["default"] != "ok" and time.monotonic() < deadline:
                    time.sleep(0.05)
                step = loop.save_snapshot()
                rec.dump("witnessed", "the served stream's end")
            finally:
                pub.stop()
                loop.stop()
        rep = agg.report()
    finally:
        server.close()
        flightrec.install_flight_recorder(None)
    return {"updates": view["updates"], "published": answers, "aggregated_updates": rep["updates"], "step": step,
            "spans": len(tr.trace_records("serve.update"))}


def overlapped_read(mtt, dev, rank):
    """Both ranks: an overlapped-sync collection's updates, then its reads."""
    import torch

    coll = mtt.MetricCollection({
        "acc": mtt.Accuracy(num_classes=C, device=dev, sync_mode="overlapped", sync_every_n=2),
        "top2": mtt.Accuracy(num_classes=C, top_k=2, device=dev, sync_mode="overlapped", sync_every_n=2),
    })
    import torch.distributed as dist

    for p, y in requests(10 + rank)[:SYNC_BATCHES]:
        coll.update(torch.from_numpy(p), torch.from_numpy(y))
    # the cycles pair across the ranks (D20): a request on each, then the
    # read (no collective) and, once both have read, the fresh sync
    dict(coll.items(keep_base=True, copy_state=False))["acc"].request_sync(wait=True, deadline_s=60.0)
    read = {k: float(v) for k, v in coll.compute().items()}
    dist.barrier()
    fresh = {k: float(v) for k, v in coll.compute(fresh=True).items()}
    return {"read": read, "fresh": fresh}


def rank_main(rank, world, store, queue, dev="cpu"):
    try:
        import torch.distributed as dist

        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.analysis import lockwitness as lw
        from metrics_tpu_torch.obs import runtime_metrics as rm
        from metrics_tpu_torch.parallel import sync

        rm.registry.fold_device = dev
        out = {"armed": lw.lockcheck_enabled() and type(sync.gather_sequence_lock).__name__ == "_WitnessLock"}
        if rank == 0:
            # one host's loop, before the world exists (its reduces sync nothing)
            with tempfile.TemporaryDirectory() as directory:
                out["served"] = served_stream(mtt, dev, directory)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        out["overlapped"] = overlapped_read(mtt, dev, rank)
        dist.barrier()
        out["findings"] = lw.findings()
        out["edges"] = {a: sorted(b) for a, b in lw._order.items()}
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
