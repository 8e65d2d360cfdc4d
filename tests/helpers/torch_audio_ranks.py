"""The ranks of the four-process check of the audio metrics in
``tests/test_torch_audio.py``: one Gloo process each, importing torch, numpy
and the port only (neither JAX nor ``metrics_tpu``).

Each rank updates a collection of SNR, SI-SDR, SDR (conjugate gradient) and
PIT with its ragged shard of seeded two-speaker clips, computes it under a
recorder of the collectives, and reports its synced sum states.
"""
import sys
import traceback
import warnings

import numpy as np

from tests.helpers.torch_fused_sync_ranks import Recorder, _numpy

SEED = 16
CLIPS = [3, 5, 2, 4]  # clips per rank: ragged
SPEAKERS = 2
SAMPLES = 256
FILTER = 32


def shards(world):
    """Each rank's (preds, target), ``(clips, SPEAKERS, SAMPLES)`` float32:
    the sources, and estimates that leak the other speaker, swapped on odd
    clips."""
    rng = np.random.default_rng(SEED)
    n = sum(CLIPS[:world])
    target = rng.standard_normal((n, SPEAKERS, SAMPLES)).astype(np.float32)
    preds = target + 0.3 * target[:, ::-1] + 0.1 * rng.standard_normal(target.shape)
    preds[1::2] = preds[1::2, ::-1]
    bounds = np.cumsum([0] + CLIPS[:world])
    return [(preds[a:b].astype(np.float32), target[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def collection(pkg, si_sdr, **kw):
    return pkg.MetricCollection({
        "snr": pkg.SignalNoiseRatio(**kw),
        "si_sdr": pkg.ScaleInvariantSignalDistortionRatio(**kw),
        "sdr_cg": pkg.SignalDistortionRatio(use_cg_iter=10, filter_length=FILTER, **kw),
        "pit": pkg.PermutationInvariantTraining(si_sdr, **kw),
    })


def rank_main(rank, world, store, queue):
    try:
        import torch
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio

        coll = collection(mtt, scale_invariant_signal_distortion_ratio, device="cpu")
        preds, target = shards(world)[rank]
        for i in range(len(preds)):
            coll.update(torch.from_numpy(preds[i : i + 1]), torch.from_numpy(target[i : i + 1]))
        with Recorder(dist) as rec:
            values = coll.compute()
        synced = {}
        for name, metric in coll.items():
            metric.sync()
            synced[name] = _numpy(metric.metric_state)
            metric.unsync()
        out = {"values": _numpy(values), "calls": rec.calls, "synced": synced}
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
