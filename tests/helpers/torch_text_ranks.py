"""The ranks of the two-process BERTScore check in ``tests/test_torch_text.py``
(ROADMAP F10): one Gloo process each, importing torch, numpy and the port
only (neither JAX nor ``metrics_tpu``).

Each rank updates ``BERTScore`` (the bundled encoder) with its batches, whose
token lengths differ between batches and between ranks, then computes under
a recorder of the collectives.
"""
import sys
import traceback
import warnings

from tests.helpers.torch_fused_sync_ranks import Recorder, _numpy

# each rank's batches: (predictions, references); 5-, 12-, 8- and 15-token
# sentences (with [CLS] and [SEP])
BATCHES = [
    [
        (["one two three", "four five six"], ["one two four", "five six"]),
        (["a b c d e f g h i j", "k l m"], ["a b c d e f g h i", "k l m n o p q r s t"]),
    ],
    [
        (["alpha beta gamma delta eps zeta"], ["alpha beta gamma delta eps"]),
        (["w1 w2 w3 w4 w5 w6 w7 w8 w9 w10 w11 w12 w13", "w1 w2"], ["w1 w2 w3", "w2 w1 w3 w4 w5 w6 w7 w8 w9 w10 w11 w12 w13"]),
        ([], []),
    ],
]


def rank_main(rank, world, store, queue, idf=False):
    try:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt

        metric = mtt.BERTScore(idf=idf, device="cpu")
        for preds, target in BATCHES[rank]:
            if preds:
                metric.update(preds, target)
        lengths = [t.shape[1] for t in metric.pred_embeddings] + [t.shape[1] for t in metric.target_embeddings]
        with Recorder(dist) as rec:
            value = metric.compute()
        out = {"value": _numpy(value), "calls": rec.calls, "local_lengths": lengths,
               "local_after": [t.shape[1] for t in metric.pred_embeddings]}
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
