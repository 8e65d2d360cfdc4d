#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line, and any failure exits non-zero:

1. device: the card, and its name and power limit as ``nvidia-smi`` reports them;
2. build: compile every CUDA kernel from ``metrics_tpu_torch/csrc/``, one
   ``nvcc`` per source, all started together;
3. parity: each kernel against its plain PyTorch version on the card,
   bit-equal, at the main paths' shapes and at the edges (K1
   ``binned_counters`` with NaN, infinite and denormal scores and thresholds
   and a histogram too large for shared memory; K2 ``histogram`` with
   sorted, run-length, Zipf and one-bin ids, misaligned data pointers,
   scalar heads and tails, and grids on both sides of each shared-memory
   limit; K3's single fold ``compactor_fold`` and its cascade
   ``fold_cascade`` / ``merge_cascade`` in insert and merge mode, including
   values of k whose buffers run out of device memory);
4. main path: an ImageNet-1k validation epoch (50,000 rows, 1000 classes,
   1024-row batches) through ``MetricCollection({acc1, acc5, bap})`` on the
   card, checked against the same run of the port on the CPU;
5. stream path: an online score monitor, 64 batches of 2^20 lognormal rows
   (0.1 % NaN/±inf) through ``MetricCollection({q: QuantileSketch, distinct:
   HyperLogLog, freq: CountMinSketch})`` at their default sizes, checked
   against the same run on the CPU and against exact answers on the card;
6. profile: where one batch update's time goes on each path (each member
   alone, and a ``torch.profiler`` window: device busy time and idle share,
   operations on the card per update, top kernels and host calls), and the
   blocking device-to-host reads of a stream update;
7. dist path: data-parallel evaluation of a binary scorer, 2^26 rows over
   4 processes that share the card in one Gloo world (``torch.distributed``,
   ``tcp://localhost``): each rank runs ``MetricCollection({auroc, ap,
   auroc_ring, ap_ring})`` over its 2^24 rows and ``compute()`` syncs the
   collection once (``fused_sync``: each compute group gathers its lists
   and rings once) and sorts all 2^26 rows on every rank; then
   ``sharded_descending_ranks`` (K2 on every rank) on quantized, continuous
   and all-equal scores, held against the gathered sort. Checked against
   the port in one process on the CPU and against an exact float64
   Mann-Whitney AUROC;
8. fused dist path: the ImageNet epoch over the same four-rank world, with
   0.5 % of the rows given a NaN score and 0.5 % the label 1000, through
   ``{acc, prec, rec, f1, bap}`` with ``on_invalid="drop"``; ``compute()``
   must make one ``all_reduce`` per (reduction, dtype) bucket of the
   states and no gather (counted by a recording wrapper around
   ``torch.distributed``), the synced fault counts must equal the injected
   rows on every rank, K1 must launch once per batch, and the values must
   equal the port's in one process on the CPU; ``all_reduce`` over Gloo is
   checked on the card for int32, int64 and float32 with SUM and MAX;
9. fused sketch path: ``{mean, q: QuantileSketch, cm: CountMinSketch}`` over
   16 batches of 2^20 lognormal rows per rank (0.1 % NaN/±inf): at most two
   ``all_reduce`` and no gather, the synced sketches bit-equal to an
   in-process ``sketch_merge`` fold of the ranks' sketches on the card
   (K3's merge cascade, launches counted), the mean against numpy;
10. sync layer, in one more four-rank world: ``overlapped_path`` (the fused
   evaluation path with every member ``sync_mode="overlapped"``, exact then
   int8: a covered view read with no collective, bit-equal to
   ``compute(fresh=True)`` and to the fused evaluation path when exact, BAP's
   counters within the int8 envelope), ``quantized_sketch_path`` (the sketch
   monitor through ``fused_sync(transport="int8"|"fp16")``: counts exact, the
   item lanes within the codec's envelope, K3's merges counted),
   ``chunked_sync`` (``chunks=4`` bit-equal to one collective, the predicted
   count of ``all_reduce``) and ``retry`` (the bounded communicator bit-equal
   over the healthy world; against a wedged peer in this process it degrades
   to the local values within its timeout, records one ``gather_degraded``,
   and returns at once while its breaker is open); before the worlds,
   ``windowed_path``: a trailing window of accuracy and a decayed mean over
   the epoch on the card, against the trailing rows, the float64 closed form
   and the CPU run. A health event in a healthy world fails the run;
11. kernels: each kernel's time, its bound on this card, and its launches on
   each path; each beside its previous design, timed in the same run: K1's
   compare per (row, class, threshold), built from
   ``csrc/binned_counters_loop.cu``; K2's warp match per id, built from
   ``csrc/histogram_match.cu``; and K3's one single-fold launch per level;
   K2 also at the confusion matrix's shape (1024 ids over 10^6 bins) beside
   ``torch.bincount``;
12. full classification path (after the windowed path): the ImageNet epoch
   through ``{cm: ConfusionMatrix, kappa: CohenKappa, mcc: MatthewsCorrCoef,
   jaccard: JaccardIndex, spec: Specificity, dice: Dice, hamming:
   HammingDistance, ce: CalibrationError(binned), hinge: HingeLoss
   (crammer-singer), f1: 2 * p * r / (p + r), bap}`` (the confusion-matrix
   family one compute group, so K2 counts once per batch) and a
   ``KLDivergence`` of the epoch's distributions against a second seeded
   model's, on the card and on the CPU: the confusion matrix bit-equal, its
   trace the top-1 rows, K1 and K2 once per batch, and a guarded
   ``ConfusionMatrix`` update with no blocking read;
13. multilabel path: a COCO-2014-val-shaped evaluation (40,504 images, 80
   labels, 512-row batches) through ``{CoverageError,
   LabelRankingAveragePrecision, LabelRankingLoss, HammingDistance,
   ConfusionMatrix(multilabel)}`` on the card and on the CPU, K2 once per
   batch;
14. full classification over four ranks (after the sync layer's world): the
   collection of phase 12 on the shards of the epoch; ``compute()`` makes
   one ``all_reduce`` per predicted bucket and no gather, and its values
   are those of the one-process CPU run.

The parent process builds every kernel before it spawns the ranks, so the
ranks only load the libraries. A rank that fails makes the script fail.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, the script prints no result and exits 1.
"""
import ctypes
import hashlib
import json
import math
import pathlib
import queue
import socket
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent

SEED = 0
ROWS = 50_000  # the ILSVRC2012 validation set
CLASSES = 1000
THRESHOLDS = 100  # BinnedAveragePrecision's default
BATCH = 1024
SIGNAL = 4.0  # added to the true class's logit, so accuracy is far above chance
FORWARD_EVERY = 16  # batches 0, 16, 32 and 48 go through forward(), the rest through update()
AP_ATOL = 1e-6  # float32 sums over thresholds, added in another order on the card

# the stream path: an online monitor of a model's scores
STREAM_BATCHES = 64
STREAM_BATCH = 1 << 20
STREAM_FORWARD_EVERY = 16  # batches 0, 16, 32 and 48 go through forward(), which merges sketches
NONFINITE_SHARE = 0.001  # rows set to NaN, +inf or -inf; the sketches leave them out
QUANTILES = (0.5, 0.9, 0.99, 0.999)
HLL_RTOL = 1e-6  # the estimate sums 2^11 float32 terms, in another order on the card
# K3's timing shape: a level of the default sketch (k = 6600) and the
# 4096 items a 2^20-row batch precompacts to
K3_K, K3_M = 6600, 4096

# the dist path: an offline evaluation of a binary scorer (a CTR or ranking
# model's held-out set is tens of millions of rows)
DIST_WORLD = 4
DIST_SHARD = 1 << 24  # rows per rank; 2^26 in all
DIST_BATCH = 1 << 20
DIST_FORWARD_EVERY = 8  # batches 0 and 8 of each rank go through forward()
DIST_RING = 1 << 24  # capacity of each rank's rings: its whole shard
POSITIVE_SHARE = 0.25
NUM_BUCKETS = 2048  # sharded_descending_ranks' default grid
K2_BINS = NUM_BUCKETS + 3  # with the +inf, -inf and overflow buckets
QUANT_GRID = 2048  # quantized scores: floor(s * 2048) / 2048, one grid point per bucket
DIST_RTOL = 1e-5  # areas: float32 sums over 2^26 terms, taken in another order than on the CPU
EXACT_ATOL = 1e-5  # AUROC against the exact float64 Mann-Whitney value
DIST_TIMEOUT_S = 600
DIST_DEVICE = "cuda:0"  # where the ranks run: the one card, shared
# the fused sync's paths, over the same four-rank world: the ImageNet epoch
# with injected faults, and a sketch monitor of 2^26 rows
FAULT_SHARE = 0.005  # rows that get a NaN score; as many again get the label CLASSES
# the (dtype, operation) buckets of a collection's compute(), as predicted
# from its states: fault counters int64 SUM; stat scores int32 SUM; BAP's
# counters, the mean's sums and the packed quantile sketches float32 SUM;
# CountMin int64 SUM
FUSED_EVAL_BUCKETS = [["float32", "SUM"], ["int32", "SUM"], ["int64", "SUM"]]
FUSED_SKETCH_BUCKETS = [["float32", "SUM"], ["int64", "SUM"]]
FUSED_SKETCH_BATCHES = 16  # batches of 2^20 rows per rank
MEAN_RTOL = 1e-5  # a float32 mean of 2^26 rows, summed in batches and across ranks, against float64
# the sync layer (phases overlapped_path, quantized_sketch_path, chunked_sync,
# retry, windowed_path)
SYNC_EVERY_N = 4  # the overlapped members' cadence: a cycle every 4 notifies
SYNC_CHUNKS = 4
RETRY_TIMEOUT_S = 1.0  # the wedged transport's bound
RETRY_SLACK_S = 0.5  # a degraded call returns within RETRY_TIMEOUT_S plus this
BREAKER_FAST_S = 0.010  # a call while the breaker is open returns within this
HEALTH_EVENTS = ("gather_degraded", "async_sync_error", "async_sync_stalled")
# the float32 roundings of a decoded lane (the scale's division and the
# product), relative to the lane, added to a codec's worst case
DECODE_ROUNDING = 2.0 ** -23
WINDOW = 8192
WINDOW_BUCKETS = 8  # 1024-row buckets: the epoch's batches fill one each
HALFLIFE = 8192.0
# the rest of classification (phases full_classification_path, multilabel_path,
# full_classification_dist): the ImageNet epoch through every classification
# metric, and a COCO-2014-val-shaped multilabel evaluation
CE_BINS = 15
# declared compute groups: the confusion-matrix family counts once per batch
# (one K2 launch), specificity and Dice share their stat scores
FULL_GROUPS = [["cm", "kappa", "mcc", "jaccard"], ["spec", "dice"], ["hamming"], ["ce"], ["hinge"], ["f1"], ["bap"]]
# its sync's buckets, as predicted from the states: confusion matrices, stat
# scores, Hamming and hinge counts int32 SUM; calibration bins, the hinge sum
# and BAP's counters float32 SUM; no list, ring or fault state, so no gather
FULL_EVAL_BUCKETS = [["float32", "SUM"], ["int32", "SUM"]]
# values from float32 sums over the epoch's rows (calibration bins, hinge,
# KL, the ranking means), added in another order on the card: within this
# share of max(1, |value|) of the CPU run's
FLOAT_SUM_RTOL = 1e-5
FLOAT_SUM_VALUES = ("ce", "hinge", "kl")
GUARDED_UPDATES = 8  # guarded ConfusionMatrix updates watched for blocking reads
PROFILE_BATCHES = 8  # updates of each new path's collection in its profiler window
ML_ROWS = 40_504  # COCO 2014 val images
ML_LABELS = 80
ML_BATCH = 512
ML_LABELS_PER_ROW = 2.9  # COCO's mean categories per image
# logit centres of a true and a false label, for a scorer of the precision
# (about 0.85) and recall (about 0.72) at threshold 0.5 that ResNet-101
# multilabel classifiers report on COCO 2014 val (ML-GCN, CVPR 2019):
# Phi(0.58) = 0.72 of true labels and Phi(-2.59) = 0.48 % of false ones score
# above 0.5, so about 0.37 false positives an image against 2.09 true ones
ML_POS_LOGIT = 0.58
ML_NEG_LOGIT = -2.59
LOOP_SOURCE = "binned_counters_loop.cu"  # K1's previous design, built only to time K1 against
MATCH_SOURCE = "histogram_match.cu"  # K2's previous design, built only to time K2 against

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")  # host calls that launch a kernel, as the profiler names them
RECORDED_SHARE = 0.95  # least share of a profiler window's launches whose records on the card it must keep


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def cuda_time_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, kernel_name, iters=50):
    """The card's own time per call of ``fn`` from a ``torch.profiler``
    window over ``iters`` calls: of ``kernel_name`` (per launch and per
    call, and its launches per call), of every operation on the card, and
    the kernel launches that ``fn`` makes on the host per call.

    The profiler keeps every launch made on the host, but late in a long
    run it has left out the card's records of whole calls at one end of a
    window (those of 10 of 50 calls, of all of 10, of 3 of 800). Per-call
    figures divide by the calls whose records were kept; a window that
    kept less than 95 % of its launches is taken again over four times the
    calls, twice at most, and then the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        on_device = [e for e in events if e.device_type == DeviceType.CUDA]
        kernels = sum(e.count for e in on_device if not e.key.startswith(("Memcpy", "Memset")))
        launches = sum(e.count for e in events if e.device_type != DeviceType.CUDA and e.key.startswith(LAUNCH_CALLS))
        if kernels >= RECORDED_SHARE * launches:
            break
        iters *= 4
    else:
        raise RuntimeError(f"the profiler recorded {kernels} kernels of {launches} launches on the host")
    calls = iters * min(1.0, kernels / launches) if launches else iters

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    hits = [e for e in on_device if kernel_name in e.key]
    us, count = sum(dev_us(e) for e in hits), sum(e.count for e in hits)
    return {
        "ms_per_launch": us / 1e3 / count if count else None,
        "ms_per_call": us / 1e3 / calls,
        "launches_per_call": count / calls,
        "all_device_ms_per_call": sum(dev_us(e) for e in on_device) / 1e3 / calls,
        "device_ops_per_call": sum(e.count for e in on_device) / calls,
        "host_launches_per_call": launches / iters,
        "recorded_share": kernels / launches if launches else None,
        "iters": iters,
    }


def device_ms_per_launch(fn, kernel_name, iters=50):
    """The card's own time for one launch of ``kernel_name``, from a
    ``torch.profiler`` window over ``iters`` calls of ``fn``. Back-to-back
    launches timed with CUDA events measure the host's enqueue rate when
    the kernel is shorter than the launch itself; this does not."""
    return device_profile(fn, kernel_name, iters)["ms_per_launch"]


def phase_build():
    from metrics_tpu_torch.ops import _build, binned_counters, compactor, histogram

    sources = [binned_counters.SOURCE, histogram.SOURCE, compactor.SOURCE, LOOP_SOURCE, MATCH_SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    for src in sources:
        _build.load(src)
    seconds = time.perf_counter() - t0
    for src in sources:
        info = _build.build_info.get(src, {})
        emit({
            "phase": "build",
            "source": f"metrics_tpu_torch/csrc/{src}",
            "library": str(_build.library_path(src).relative_to(ROOT)),
            "built_now": bool(info),
            "nvcc_s": info.get("seconds"),
            "seconds_all_sources": seconds,
            "ptxas": info.get("ptxas", []),
        })


def make_data(device):
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    target = torch.randint(0, CLASSES, (ROWS,), generator=g, device=device)
    logits = torch.randn((ROWS, CLASSES), generator=g, device=device)
    logits[torch.arange(ROWS, device=device), target] += SIGNAL
    preds = torch.softmax(logits, dim=1)
    return preds, target


def phase_parity(preds, target):
    """K1 against its plain version on the card, bit for bit: the main
    path's shape, and scores and thresholds at every edge the binary search
    and the histogram meet."""
    import torch

    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.utilities.data import jax_linspace, to_onehot

    dev = preds.device
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    thr = jax_linspace(0, 1.0, THRESHOLDS, device=dev)
    onehot = to_onehot(target[:BATCH], CLASSES) == 1
    p = preds[:BATCH]

    nasty = p.clone()
    pick = torch.rand(nasty.shape, generator=g, device=dev)
    nasty[pick < 0.1] = float("nan")
    nasty[(pick >= 0.1) & (pick < 0.15)] = float("inf")
    nasty[(pick >= 0.15) & (pick < 0.2)] = float("-inf")
    # scores around zero: denormals of both signs, both zeros, the smallest normal
    edge_values = torch.tensor([1e-40, -1e-40, 1e-45, -1e-45, 0.0, -0.0, 1.1754944e-38, -1.1754944e-38, float("nan"),
                                float("inf"), float("-inf"), 0.5], device=dev)
    edges = edge_values[torch.randint(0, edge_values.numel(), (BATCH, CLASSES), generator=g, device=dev)]
    edge_thr = torch.tensor([0.5, 0.0, -0.0, 1e-41, -1e-41, float("nan"), 0.5, 1.1754944e-38, float("-inf"), float("inf"),
                             0.0, 1e-45, float("nan"), -1.0], device=dev)
    on_thr = thr[torch.randint(0, THRESHOLDS, (BATCH, CLASSES), generator=g, device=dev)]
    unsorted = torch.cat([torch.rand(30, generator=g, device=dev), thr[torch.tensor([5, 5, 50, 0, 99, 99, 42], device=dev)]])
    small = lambda n, c: (torch.rand((n, c), generator=g, device=dev), torch.rand((n, c), generator=g, device=dev) < 0.3)  # noqa: E731

    cases = [
        ("full", p, onehot, thr),
        ("n0", p[:0], onehot[:0], thr),
        ("n1", p[:1], onehot[:1], thr),
        ("n848", p[:848], onehot[:848], thr),
        ("c1", p[:, :1].contiguous(), onehot[:, :1].contiguous(), thr),
        ("t5", p, onehot, jax_linspace(0, 1.0, 5, device=dev)),
        ("nan_inf", nasty, onehot, thr),
        ("equal_to_thresholds", on_thr, onehot, thr),
        ("unsorted_duplicated_thresholds", p, onehot, unsorted),
        ("denormal_nan_inf_scores_and_thresholds", edges, onehot, edge_thr),
        ("denormal_scores_linspace_thresholds", edges, onehot, thr),
        ("t1000", *small(256, 64), jax_linspace(0, 1.0, 1000, device=dev)),
        ("t5000", *small(64, 3), torch.rand(5000, generator=g, device=dev)),
        # one class's 2 (T + 1) bins exceed a block's shared memory: the histogram lives in device memory
        ("t30000_histogram_in_device_memory", *small(300, 5), torch.rand(30000, generator=g, device=dev)),
    ]
    rows = []
    max_err = 0.0
    for name, pp, tt, th in cases:
        got = k1.binned_counter_update(pp, tt, th)
        want = k1.binned_counter_update_plain(pp, tt, th)
        torch.cuda.synchronize()
        equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(got, want))
        max_err = max(max_err, err)
        rows.append({"case": name, "shape": [pp.shape[0], pp.shape[1], th.shape[0]], "bit_equal": equal, "max_abs_err": err})
        if not equal:
            emit({"phase": "parity", "cases": rows})
            raise AssertionError(f"binned_counters kernel differs from its plain version in case {name!r}")
    full_err = rows[0]["max_abs_err"]
    emit({"phase": "parity", "kernel": "binned_counters", "cases": rows, "max_abs_err": max_err})
    return full_err


def build_collection(pkg, device):
    return pkg.MetricCollection({
        "acc1": pkg.Accuracy(num_classes=CLASSES, device=device),
        "acc5": pkg.Accuracy(num_classes=CLASSES, top_k=5, device=device),
        "bap": pkg.BinnedAveragePrecision(num_classes=CLASSES, thresholds=THRESHOLDS, device=device),
    })


def run_epoch(coll, preds, target, sync):
    """One pass over the epoch; returns the forward values and per-call seconds."""
    forward_vals, update_s, forward_s = [], [], []
    for i, start in enumerate(range(0, ROWS, BATCH)):
        p, y = preds[start:start + BATCH], target[start:start + BATCH]
        t0 = time.perf_counter()
        if i % FORWARD_EVERY == 0:
            forward_vals.append(coll(p, y))
            sync()
            forward_s.append(time.perf_counter() - t0)
        else:
            coll.update(p, y)
            sync()
            update_s.append(time.perf_counter() - t0)
    return forward_vals, update_s, forward_s


def _same_values(a, b, what):
    import torch

    for key in b:
        x, y = a[key], b[key]
        if isinstance(y, list):
            x, y = torch.stack(x).cpu(), torch.stack(y).cpu()
            if x.shape != y.shape or not bool(torch.isfinite(x).all()) or float((x - y).abs().max()) > AP_ATOL:
                raise AssertionError(f"{what}: {key} differs from the CPU run beyond atol={AP_ATOL}")
        elif not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: {key} = {float(x)} on the card, {float(y)} on the CPU")


def phase_main_path(preds, target):
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1

    dev = preds.device
    n_batches = -(-ROWS // BATCH)
    coll = build_collection(mtt, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    k1.reset_launch_count()
    t0 = time.perf_counter()
    fwd, update_s, forward_s = run_epoch(coll, preds, target, torch.cuda.synchronize)
    loop_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    result = coll.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t1
    launches = k1.launch_count

    members = dict(coll.items(keep_base=True, copy_state=False))
    for name, m in members.items():
        for key, value in m.metric_state.items():
            if value.device.type != "cuda":
                raise AssertionError(f"state {name}.{key} lies on {value.device}, not on the card")
    if members["bap"].thresholds.device.type != "cuda":
        raise AssertionError("bap thresholds are not on the card")
    bap_updates = members["bap"].update_count
    if not (launches == bap_updates == n_batches):
        raise AssertionError(f"K1 launched {launches} times for {bap_updates} bap updates over {n_batches} batches")

    acc1, acc5, bap = result["acc1"], result["acc5"], result["bap"]
    if acc1.shape != () or acc5.shape != () or len(bap) != CLASSES or any(v.shape != () for v in bap):
        raise AssertionError("results have unexpected shapes")
    bap_t = torch.stack(bap)
    if not (bool(torch.isfinite(bap_t).all()) and 0.0 <= float(acc1) <= float(acc5) <= 1.0):
        raise AssertionError(f"implausible results: acc1={float(acc1)}, acc5={float(acc5)}")
    direct_top1 = (preds.argmax(dim=1) == target).sum().to(torch.float32) / ROWS
    if not torch.equal(acc1, direct_top1):
        raise AssertionError(f"acc1 {float(acc1)} != argmax accuracy {float(direct_top1)}")

    # the same run of the port on the CPU, where K1 is its plain version
    t2 = time.perf_counter()
    cpu = build_collection(mtt, "cpu")
    cpu_fwd, _, _ = run_epoch(cpu, preds.cpu(), target.cpu(), lambda: None)
    cpu_result = cpu.compute()
    cpu_s = time.perf_counter() - t2
    _same_values(result, cpu_result, "compute()")
    for i, (a, b) in enumerate(zip(fwd, cpu_fwd)):
        _same_values(a, b, f"forward call {i}")
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    for name, m in members.items():
        for key, value in m.metric_state.items():
            if not torch.equal(value.cpu(), cpu_members[name].metric_state[key]):
                raise AssertionError(f"state {name}.{key} differs between the card and the CPU")

    emit({
        "phase": "main_path",
        "config": {"rows": ROWS, "classes": CLASSES, "thresholds": THRESHOLDS, "batch": BATCH, "seed": SEED},
        "batches": n_batches,
        "update_calls": len(update_s),
        "forward_calls": len(forward_s),
        "rows_per_s": ROWS / loop_s,
        "epoch_s": loop_s,
        # the first forward and the first update carry one-time costs (lazy
        # loading of each CUDA kernel, compute-group forming)
        "first_forward_ms": forward_s[0] * 1e3,
        "first_update_ms": update_s[0] * 1e3,
        "rows_per_s_after_first_batch": (ROWS - BATCH) / (loop_s - forward_s[0]),
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "forward_p50_ms": statistics.median(forward_s) * 1e3,
        "compute_s": compute_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "k1_launches": launches,
        "acc1": float(acc1),
        "acc5": float(acc5),
        "bap_mean": float(bap_t.mean()),
        "cpu_reference_s": cpu_s,
        "matches_cpu_run": True,
    })
    return launches, [float(v) for v in cpu_result["bap"]]


def k1_times(preds, target, launches, max_abs_err):
    """K1's entry of the kernels line."""
    import torch

    from metrics_tpu_torch.ops import _build
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.utilities.data import jax_linspace, to_onehot

    dev = preds.device
    p = preds[:BATCH].contiguous()
    tgt = to_onehot(target[:BATCH], CLASSES) == 1
    thr = jax_linspace(0, 1.0, THRESHOLDS, device=dev)
    n, c, t = BATCH, CLASSES, THRESHOLDS

    # the kernel alone, into preallocated buffers; its scratch must start at zero
    lib = k1._library()
    tgt_u8 = tgt.view(torch.uint8)
    sorted_thr, perm = k1.threshold_order(thr)
    scratch = torch.zeros(2 * c * (t + 1) + c, dtype=torch.int32, device=dev)
    out = torch.empty((3, c, t), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def raw(rows=n):
        scratch.zero_()
        err = lib.binned_counters_launch(p.data_ptr(), tgt_u8.data_ptr(), sorted_thr.data_ptr(), perm.data_ptr(),
                                         scratch.data_ptr(), out.data_ptr(), rows, c, t, stream)
        if err:
            raise RuntimeError(f"binned_counters launch failed with cudaError {err}")

    # the previous design (a compare per row, class and threshold), built from
    # csrc/binned_counters_loop.cu: alone into a zeroed buffer, and as its
    # wrapper called it (zeros, launch, a float32 copy)
    loop = _build.load(LOOP_SOURCE).binned_counters_loop_launch
    loop.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    loop.restype = ctypes.c_int
    loop_out = torch.zeros((3, c, t), dtype=torch.int32, device=dev)

    def prev_raw():
        loop_out.zero_()
        err = loop(p.data_ptr(), tgt_u8.data_ptr(), thr.data_ptr(), loop_out.data_ptr(), n, c, t, stream)
        if err:
            raise RuntimeError(f"binned_counters_loop launch failed with cudaError {err}")

    def prev_wrapper():
        prev_raw()
        return loop_out.to(torch.float32).unbind(0)

    prev_raw()
    if not torch.equal(loop_out.to(torch.float32), torch.stack(k1.binned_counter_update(p, tgt, thr))):
        raise AssertionError("the previous K1 design and the kernel disagree on the timing inputs")

    # as the metric calls it, with the thresholds' order kept
    wrapper = lambda: k1.binned_counter_update(p, tgt, thr, (sorted_thr, perm))  # noqa: E731
    plain = lambda: k1.binned_counter_update_plain(p, tgt, thr)  # noqa: E731
    # in turns, so drift on the card touches every version alike
    order = [("plain", plain), ("prev_wrapper", prev_wrapper), ("wrapper", wrapper), ("kernel", raw), ("prev_kernel", prev_raw),
             ("prev_kernel", prev_raw), ("kernel", raw), ("wrapper", wrapper), ("prev_wrapper", prev_wrapper), ("plain", plain)]
    times = {}
    for name, fn in order:
        times.setdefault(name, []).append(cuda_time_ms(fn))
    ms = {name: statistics.mean(v) for name, v in times.items()}

    bytes_moved = n * c * (4 + 1) + t * 4 + 3 * c * t * 4  # f32 scores, u8 labels, f32 thresholds in; i32 counts out
    compares = n * c * t
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = compares / FP32_OPS_PER_S * 1e3
    return {
        "name": "binned_counters",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/binned_counters.cu",
        "replaces": "metrics_tpu/ops/binned_counters.py:32",
        "replaces_fn": "metrics_tpu/ops/binned_counters.py::_counter_kernel",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms["wrapper"],
        "kernel_ms": ms["kernel"],  # with the scratch's memset before each launch
        "kernel_device_ms": device_ms_per_launch(raw, "binned_counters_kernel"),
        # the same launch over no rows: the kernel's fixed cost (zeroing, flush, tile counter, suffix sums)
        "kernel_device_ms_no_rows": device_ms_per_launch(lambda: raw(0), "binned_counters_kernel"),
        "plain_ms": ms["plain"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [n, c, t],
        "bytes": bytes_moved,
        "compares": compares,
        "previous_design": {
            "what": "a compare per (row, class, threshold), csrc/binned_counters_loop.cu, timed in this run",
            "ms": ms["prev_wrapper"],
            "kernel_ms": ms["prev_kernel"],  # with the buffer's memset before each launch
            "kernel_device_ms": device_ms_per_launch(prev_raw, "binned_counters_loop_kernel"),
        },
    }


def profile_summary(prof, wall_s, batches):
    """Device busy time and idle share of a profiled window, and its top
    device and host items per batch."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    events = prof.key_averages()
    # only the card's own events (kernels, copies): a host op also carries
    # the device time of the kernels it launched, which would count it twice
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in on_device)
    top_device = sorted(on_device, key=dev_us, reverse=True)[:12]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    return {
        "batches": batches,
        "wall_ms_per_batch": wall_s * 1e3 / batches,
        "device_busy_ms_per_batch": device_us / 1e3 / batches,
        "device_idle_share": 1.0 - device_us / 1e6 / wall_s,
        "top_device_ms_per_batch": [[e.key, dev_us(e) / 1e3 / batches, e.count // batches] for e in top_device if dev_us(e) > 0],
        "top_host_ms_per_batch": [[e.key, e.self_cpu_time_total / 1e3 / batches, e.count // batches] for e in top_cpu],
        # operations on the card (kernels, copies, memsets) per batch
        "device_ops_per_batch": sum(e.count for e in on_device) / batches,
        # the port's own kernels, wherever they rank
        "port_kernels_ms_per_batch": {
            name: sum(dev_us(e) for e in on_device if name in e.key) / 1e3 / batches
            for name in ("binned_counters_kernel", "histogram_kernel", "compactor_fold_kernel", "compactor_cascade_kernel")
        },
        # a blocking device-to-host read waits in one stream synchronisation
        "stream_syncs_per_batch": sum(e.count for e in events if e.key == "cudaStreamSynchronize") / batches,
    }


def phase_profile(preds, target, batches=PROFILE_BATCHES):
    """Where an update's time goes: each member's update alone, and a
    ``torch.profiler`` window over the collection's updates."""
    import torch

    import metrics_tpu_torch as mtt

    def batch(i):
        s = (i % (ROWS // BATCH)) * BATCH
        return preds[s:s + BATCH], target[s:s + BATCH]

    member_p50_ms = {}
    for name, m in build_collection(mtt, preds.device).items(keep_base=True, copy_state=False):
        times = []
        for i in range(batches + 2):
            t0 = time.perf_counter()
            m.update(*batch(i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        member_p50_ms[name] = statistics.median(times[2:]) * 1e3

    # after three warm-up updates: compute groups form at the first
    profiled = profile_updates(build_collection(mtt, preds.device), preds, target, BATCH)
    emit({"phase": "profile", "member_update_p50_ms": member_p50_ms, **profiled})


def _level_run(n, count, gen, dev, ties=False):
    """An ascending (n,) float32 run, +inf past ``count``."""
    import torch

    if ties:
        vals = torch.randint(0, 4, (n,), generator=gen, device=dev).to(torch.float32)
    else:
        vals = torch.rand(n, generator=gen, device=dev)
    vals = torch.sort(vals).values
    return torch.where(torch.arange(n, device=dev) < count, vals, float("inf"))


def _count(c, dev):
    import torch

    return torch.tensor(c, dtype=torch.int32, device=dev)


def phase_k3_parity(dev):
    """K3 against its plain version on the card, bit for bit: the shapes of
    the stream path (k = 6600, an insert's 4096 items, a merge's 3k run and
    its level-with-carry merge) and every edge."""
    import torch

    from metrics_tpu_torch.ops import compactor as k3

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    k = K3_K
    run = lambda n, c, ties=False: (_level_run(n, c, g, dev, ties), _count(c, dev))  # noqa: E731
    cases = [
        # name, (a, a_count), (b, b_count), k
        ("insert_overflow", run(k, 6000), run(K3_M, 4096), k),
        ("insert_odd_leftover", run(k, 6001), run(K3_M, 4096), k),
        ("insert_absorb", run(k, 1000), run(K3_M, 4096), k),
        ("merge_fold", run(k, 5000), run(3 * k, 9000), k),
        ("merge_level_with_carry", run(k, 4000), run(2 * k, 7000), 3 * k),
        ("nothing_incoming", run(k, 3000), run(K3_M, 0), k),
        ("c_eq_k", run(k, 2600), run(K3_M, 4000), k),
        ("c_eq_k_plus_1", run(k, 2601), run(K3_M, 4000), k),
        ("all_inf", run(k, 0), run(K3_M, 0), k),
        ("k8", run(8, 5), run(4, 3), 8),
        ("k8_full", run(8, 8), run(8, 8), 8),
        ("heavy_ties", run(k, 6600, True), run(K3_M, 4096, True), k),
        ("m_2_16_many_blocks", run(k, 6500), run(70_000, 65_536), k),
    ]
    rows, max_err = [], 0.0
    for name, (a, ca), (b, cb), kk in cases:
        got = k3.compactor_fold(a, ca, b, cb, kk)
        want = k3.compactor_fold_plain(a, ca, b, cb, kk)
        torch.cuda.synchronize()
        equal = all(x.shape == y.shape and torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(got, want))
        err = max(
            float(torch.where(x == y, 0.0, (x.double() - y.double()).abs()).max()) if x.numel() else 0.0
            for x, y in zip(got, want)
        )
        max_err = max(max_err, err)
        rows.append({
            "case": name, "na": a.shape[0], "nb": b.shape[0], "k": kk,
            "c": int(ca) + int(cb), "count": int(got[1]), "pcount": int(got[3]), "bit_equal": equal,
        })
        if not equal:
            emit({"phase": "parity", "kernel": "compactor_fold", "cases": rows})
            raise AssertionError(f"compactor_fold kernel differs from its plain version in case {name!r}")
    emit({"phase": "parity", "kernel": "compactor_fold", "cases": rows, "max_abs_err": max_err})
    return max_err


def _levels(levels, k, fill, gen, dev, ties=False, extremes=False):
    """A sketch's (levels, k) items, level l ascending with ``fill[l]``
    valid values and +inf past them, and its int32 counts. ``extremes``: the
    valid prefix starts with -inf and ends with +inf."""
    import torch

    rows = []
    for c in fill:
        row = _level_run(k, c, gen, dev, ties)
        if extremes and c >= 4:
            row[:2] = float("-inf")
            row[c - 1] = float("inf")
        rows.append(row)
    return torch.stack(rows), torch.tensor(fill, dtype=torch.int32, device=dev)


def phase_k3_cascade_parity(dev):
    """The cascade kernel against its plain version (the per-level folds) on
    the card, bit for bit, in insert and merge mode: the stream's shape, an
    empty state, a saturated top level, ties with -inf/+inf values and +inf
    padding, and values of k whose buffers exceed a block's shared memory
    (they run out of device memory)."""
    import torch

    from metrics_tpu_torch.ops import compactor as k3

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    L, k, m = 20, K3_K, K3_M
    start = 8  # the level of a 2^20-row batch's 4096 items at k = 6600

    def rand_fill(levels, kk):
        return torch.randint(0, kk + 1, (levels,), generator=g, device=dev).tolist()

    def insert(name, levels, kk, fill, mm, mc, st, **kw):
        items, counts = _levels(levels, kk, fill, g, dev, **kw)
        inc = _level_run(mm, mc, g, dev, kw.get("ties", False))
        return name, "insert", (items, counts, inc, _count(mc, dev), st)

    def merge(name, levels, kk, fill_a, fill_b, **kw):
        a = _levels(levels, kk, fill_a, g, dev, **kw)
        b = _levels(levels, kk, fill_b, g, dev, **kw)
        return name, "merge", (*a, *b)

    chain = rand_fill(start, k) + [k - 100] * 6 + rand_fill(L - start - 6, k)
    cases = [
        insert("insert_stream_shape", L, k, chain, m, m, start),
        insert("insert_empty_state", L, k, [0] * L, m, m, start),
        insert("insert_empty_run", L, k, rand_fill(L, k), m, 0, start),
        insert("insert_saturated_top", L, k, [k] * L, m, m, start),
        insert("insert_at_level_0", L, k, [k - 1] * L, m, 4093, 0),
        insert("insert_ties_and_infinities", L, k, [k - 50] * 12 + rand_fill(L - 12, k), m, m, start, ties=True, extremes=True),
        insert("insert_k16384_device_memory", 6, 16384, [16384, 16383, 16384, 16000, 9000, 3], 16384, 16384, 0),
        insert("insert_k66000_device_memory", 4, 66000, [66000, 65999, 66000, 100], 4096, 4096, 0),
        merge("merge_stream_shape", L, k, rand_fill(L, k), rand_fill(L, k)),
        merge("merge_both_empty", L, k, [0] * L, [0] * L),
        merge("merge_with_an_empty_sketch", L, k, rand_fill(L, k), [0] * L),
        merge("merge_saturated_top", L, k, [k] * L, [k] * L),
        merge("merge_ties_and_infinities", L, k, [k] * 10 + rand_fill(L - 10, k), rand_fill(L, k), ties=True, extremes=True),
        merge("merge_k10000_device_memory", 8, 10000, rand_fill(8, 10000), [10000] * 8),
        merge("merge_k66000_device_memory", 4, 66000, [66000, 30000, 66000, 5], [65999, 66000, 1, 0]),
    ]
    rows, max_err = [], 0.0
    for name, mode, args in cases:
        if mode == "insert":
            got = [k3.fold_cascade(*args)]
            want = k3.fold_cascade_plain(*args)
        else:
            items, counts, o_items, o_counts = args
            got = [k3.merge_cascade(*args), k3.merge_cascade(o_items, o_counts, items, counts)]
            want = k3.merge_cascade_plain(*args)
        torch.cuda.synchronize()
        equal = all(
            x.shape == y.shape and torch.equal(x.view(torch.int32), y.view(torch.int32)) for out in got for x, y in zip(out, want)
        )
        err = max(
            float(torch.where(x == y, 0.0, (x.double() - y.double()).abs()).nan_to_num(float("inf")).max())
            for out in got for x, y in zip(out, want)
        )
        max_err = max(max_err, err)
        L_, k_ = args[0].shape
        rows.append({
            "case": name, "mode": mode, "levels": L_, "k": k_, "staged_in_shared_memory": k3._scratch_floats(k_, 0 if mode == "merge" else args[2].shape[0], mode == "merge") == 0,
            "counts_in": args[1].tolist(), "counts_out": got[0][1].tolist(), "bit_equal": equal,
        })
        if not equal:
            emit({"phase": "parity", "kernel": "compactor_cascade", "cases": rows})
            raise AssertionError(f"compactor_cascade kernel differs from its plain version in case {name!r}")
    emit({"phase": "parity", "kernel": "compactor_cascade", "cases": rows, "max_abs_err": max_err})
    return max_err


def make_stream(device):
    """The stream on the card, from a seeded generator: lognormal scores with
    NaN, +inf and -inf rows."""
    import torch

    n = STREAM_BATCHES * STREAM_BATCH
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    x = torch.empty(n, device=device).log_normal_(0.0, 1.0, generator=g)
    pick = torch.rand(n, generator=g, device=device)
    third = NONFINITE_SHARE / 3
    x[pick < third] = float("nan")
    x[(pick >= third) & (pick < 2 * third)] = float("inf")
    x[(pick >= 2 * third) & (pick < NONFINITE_SHARE)] = float("-inf")
    return x


def build_monitor(pkg, device):
    return pkg.MetricCollection({
        "q": pkg.QuantileSketch(eps=0.01, quantiles=QUANTILES, device=device),
        "distinct": pkg.HyperLogLog(device=device),
        "freq": pkg.CountMinSketch(depth=4, width=2048, device=device),
    })


def run_stream(coll, x, sync):
    """Every 16th batch through forward, the rest through update."""
    update_s, forward_s = [], []
    for i in range(STREAM_BATCHES):
        batch = x[i * STREAM_BATCH:(i + 1) * STREAM_BATCH]
        t0 = time.perf_counter()
        if i % STREAM_FORWARD_EVERY == 0:
            coll(batch)
            sync()
            forward_s.append(time.perf_counter() - t0)
        else:
            coll.update(batch)
            sync()
            update_s.append(time.perf_counter() - t0)
    return update_s, forward_s


def predicted_k3_launches(state, batch_rows, updates, forwards):
    """Each insert is one cascade launch per chunk of its batch (a batch
    that would promote past the top level is split, ``QuantileSketchState.insert``);
    a forward adds one merge, which is one more launch."""
    from metrics_tpu_torch.ops.binning import halving_level

    L, k = state.items.shape
    per_insert = 1 << max(0, halving_level(batch_rows, k) - (L - 1))
    return updates * per_insert + forwards * (per_insert + 1)


def phase_stream(x):
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import compactor as k3

    dev = x.device
    coll = build_monitor(mtt, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    k1.reset_launch_count()
    k3.reset_launch_count()
    t0 = time.perf_counter()
    update_s, forward_s = run_stream(coll, x, torch.cuda.synchronize)
    loop_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    result = coll.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t1
    launches, k1_launches, fold_launches = k3.launch_count, k1.launch_count, k3.fold_launch_count
    peak_mem = torch.cuda.max_memory_allocated()  # before the checks below allocate

    members = dict(coll.items(keep_base=True, copy_state=False))
    for name, m in members.items():
        for field, t in zip(m.metric_state["sketch"]._fields, m.metric_state["sketch"]):
            if t.device.type != "cuda":
                raise AssertionError(f"state {name}.sketch.{field} lies on {t.device}, not on the card")
    q_state = members["q"].metric_state["sketch"]
    want = predicted_k3_launches(q_state, STREAM_BATCH, len(update_s), len(forward_s))
    if not (launches == want and launches > 0 and fold_launches == 0):
        raise AssertionError(
            f"K3's cascade launched {launches} times on the stream path (single folds: {fold_launches}); the code predicts {want}"
        )

    # the same stream through the port on the CPU
    t2 = time.perf_counter()
    cpu = build_monitor(mtt, "cpu")
    run_stream(cpu, x.cpu(), lambda: None)
    cpu_result = cpu.compute()
    cpu_s = time.perf_counter() - t2
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    for name, m in members.items():
        for field, a, b in zip(m.metric_state["sketch"]._fields, m.metric_state["sketch"], cpu_members[name].metric_state["sketch"]):
            if a.dtype != b.dtype or not torch.equal(a.cpu().reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)):
                raise AssertionError(f"state {name}.sketch.{field} differs between the card and the CPU")
    if not torch.equal(result["q"].cpu(), cpu_result["q"]) or not torch.equal(result["freq"].cpu(), cpu_result["freq"]):
        raise AssertionError("compute() of q or freq differs between the card and the CPU")
    if not torch.allclose(result["distinct"].cpu(), cpu_result["distinct"], rtol=HLL_RTOL, atol=0.0):
        raise AssertionError(f"distinct {float(result['distinct'])} on the card, {float(cpu_result['distinct'])} on the CPU")

    # exact answers, on the card
    finite = x[torch.isfinite(x)]
    n = finite.numel()
    if int(q_state.n_seen) != n:
        raise AssertionError(f"the sketch saw {int(q_state.n_seen)} rows, the stream has {n} finite rows")
    ordered = torch.sort(finite).values
    eps_bound = q_state.eps_bound
    q_vals = result["q"]
    rank_err = []
    for q, v in zip(QUANTILES, q_vals.tolist()):
        vt = torch.tensor([v], device=dev)
        lo = int(torch.searchsorted(ordered, vt, side="left"))
        hi = int(torch.searchsorted(ordered, vt, side="right"))
        target = q * n
        rank_err.append(max(0.0, lo - target, target - hi) / n)
    if not all(e <= eps_bound for e in rank_err):
        raise AssertionError(f"quantile rank errors {rank_err} exceed eps_bound {eps_bound}")
    distinct_exact = int(torch.unique(finite).numel())
    distinct_est = float(result["distinct"])
    hll_bound = 4 * 1.04 / (members["distinct"].metric_state["sketch"].registers.numel() ** 0.5)
    hll_rel = abs(distinct_est - distinct_exact) / distinct_exact
    if hll_rel > hll_bound:
        raise AssertionError(f"HLL estimate {distinct_est} vs exact {distinct_exact}: relative error {hll_rel} > {hll_bound}")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    probe = finite[torch.randint(0, n, (4096,), generator=g, device=dev)]
    exact = torch.searchsorted(ordered, probe, side="right") - torch.searchsorted(ordered, probe, side="left")
    est = members["freq"].query(probe)
    if bool((est < exact).any()):
        raise AssertionError("CountMin under-counted a probed value")
    del ordered, finite

    rows = STREAM_BATCHES * STREAM_BATCH
    emit({
        "phase": "stream_path",
        "config": {
            "batches": STREAM_BATCHES, "batch": STREAM_BATCH, "rows": rows, "nonfinite_share": NONFINITE_SHARE,
            "quantile_sketch": list(q_state.items.shape), "hll_registers": members["distinct"].metric_state["sketch"].registers.numel(),
            "count_min": list(members["freq"].metric_state["sketch"].counts.shape), "seed": SEED,
        },
        "update_calls": len(update_s),
        "forward_calls": len(forward_s),
        "rows_per_s": rows / loop_s,
        "stream_s": loop_s,
        "first_forward_ms": forward_s[0] * 1e3,
        "first_update_ms": update_s[0] * 1e3,
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "forward_p50_ms": statistics.median(forward_s) * 1e3,
        "compute_s": compute_s,
        "peak_mem_bytes": peak_mem,
        "k3_launches": launches,
        "k3_launches_predicted": want,
        "k3_single_fold_launches": fold_launches,
        "k1_launches": k1_launches,
        "quantiles": dict(zip(map(str, QUANTILES), q_vals.tolist())),
        "quantile_rank_err": rank_err,
        "eps_bound": eps_bound,
        "distinct_est": distinct_est,
        "distinct_exact": distinct_exact,
        "hll_rel_err": hll_rel,
        "count_min_max_overcount": int((est - exact).max()),
        "finite_rows": n,
        "cpu_reference_s": cpu_s,
        "matches_cpu_run": True,
    })
    return launches, q_state


def phase_stream_profile(x, batches=6):
    """Where a stream update's time goes, and how many times it blocks on
    the card (sync debug mode warns at every blocking device-to-host read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import metrics_tpu_torch as mtt

    def batch(i):
        return x[i * STREAM_BATCH:(i + 1) * STREAM_BATCH]

    coll = build_monitor(mtt, x.device)
    for i in range(3):  # warm-up; compute groups form at the first update
        coll.update(batch(i))
    torch.cuda.synchronize()
    blocking = blocking_reads(lambda i: coll.update(batch(3 + i)), batches)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3 + batches, 3 + 2 * batches):
            coll.update(batch(i))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    emit({
        "phase": "profile_stream",
        "blocking_reads_per_update": len(blocking) / batches,
        "blocking_reads_seen": blocking[:5],
        **profile_summary(prof, wall_s, batches),
    })


def k3_times(dev, launches, max_abs_err, fold_max_abs_err, q_state, batch):
    """K3's entry of the kernels line: one cascade at the stream path's
    shape, on its own data. The stream's first batch (4096 items at level
    8) is folded into the monitor's final quantile state, where level 8
    absorbs it, and into that state after one such insert, where level 8
    overflows and promotes; the merge merges those two states. Beside each,
    the previous design (one single-fold launch per level), timed in the
    same run."""
    import torch

    from metrics_tpu_torch.ops import compactor as k3
    from metrics_tpu_torch.ops.binning import precompact_binned

    items, counts = q_state.items.contiguous(), q_state.counts.contiguous()
    L, k = items.shape
    inc, inc_count, level = precompact_binned(batch, torch.ones_like(batch, dtype=torch.bool), k)
    m = inc.shape[0]
    items2, counts2 = k3.fold_cascade(items, counts, inc, inc_count, level)
    # the previous design must give the same states, bit for bit
    for a, b in ((items, counts), (items2, counts2)):
        per_level = k3.fold_cascade_plain(a, b, inc, inc_count, level, fold=k3.compactor_fold)
        for got, want in zip(per_level, k3.fold_cascade(a, b, inc, inc_count, level)):
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError("the per-level insert and the cascade kernel disagree on the stream's state")

    lib = k3._library()
    stream_ptr = torch.cuda.current_stream(dev).cuda_stream
    out_items = torch.empty_like(items)
    out_counts = torch.empty_like(counts)
    inc_count1 = inc_count.reshape(1).to(torch.int32)

    def raw_insert(a, b):
        def run():
            err = lib.compactor_cascade_launch(a.data_ptr(), b.data_ptr(), L, k, inc.data_ptr(), m, inc_count1.data_ptr(), level,
                                               None, None, out_items.data_ptr(), out_counts.data_ptr(), None, stream_ptr)
            if err:
                raise RuntimeError(f"compactor_cascade launch failed with cudaError {err}")
        return run

    def raw_merge():
        err = lib.compactor_cascade_launch(items2.data_ptr(), counts2.data_ptr(), L, k, None, 0, None, 0, items.data_ptr(),
                                           counts.data_ptr(), out_items.data_ptr(), out_counts.data_ptr(), None, stream_ptr)
        if err:
            raise RuntimeError(f"compactor_cascade launch failed with cudaError {err}")

    def insert_fns(a, b):
        return {
            "kernel": raw_insert(a, b),
            "wrapper": lambda: k3.fold_cascade(a, b, inc, inc_count, level),
            "plain": lambda: k3.fold_cascade_plain(a, b, inc, inc_count, level),
            "per_level": lambda: k3.fold_cascade_plain(a, b, inc, inc_count, level, fold=k3.compactor_fold),
            # the levels and counts in, the run and its count in; the levels and counts out
            "bytes": 2 * (L * k * 4 + L * 4) + m * 4 + 4,
            "counts_in": b.tolist(),
        }

    shapes = {
        "insert_promotes": insert_fns(items2, counts2),
        "insert_absorbs": insert_fns(items, counts),
        "merge": {
            "kernel": raw_merge,
            "wrapper": lambda: k3.merge_cascade(items2, counts2, items, counts),
            "plain": lambda: k3.merge_cascade_plain(items2, counts2, items, counts),
            "per_level": lambda: k3.merge_cascade_plain(items2, counts2, items, counts, fold=k3.compactor_fold),
            "bytes": 3 * (L * k * 4 + L * 4),
            "counts_in": [counts2.tolist(), counts.tolist()],
        },
    }
    out = {}
    for shape, fns in shapes.items():
        # in turns, so drift on the card touches every version alike
        order = ["plain", "per_level", "wrapper", "kernel", "kernel", "wrapper", "per_level", "plain"]
        times = {}
        for name in order:
            times.setdefault(name, []).append(cuda_time_ms(fns[name], iters=100, warmup=10))
        ms = {name: statistics.mean(v) for name, v in times.items()}
        cascade = device_profile(fns["kernel"], "compactor_cascade_kernel")
        previous = device_profile(fns["per_level"], "compactor_fold_kernel")
        bytes_ms = fns["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = (L * k + (m if shape.startswith("insert") else L * k)) / FP32_OPS_PER_S * 1e3  # a compare per merged value
        out[shape] = {
            "ms": ms["wrapper"],
            "kernel_ms": ms["kernel"],
            "kernel_device_ms": cascade["ms_per_launch"],
            "plain_ms": ms["plain"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": fns["bytes"],
            "counts_in": fns["counts_in"],
            "previous_design": {
                "what": "one single-fold launch per level (the previous design), timed in this run",
                "ms": ms["per_level"],
                "fold_launches_per_call": previous["launches_per_call"],
                "fold_device_ms_per_launch": previous["ms_per_launch"],
                "fold_device_ms_per_call": previous["ms_per_call"],
                "all_device_ms_per_call": previous["all_device_ms_per_call"],
                "device_ops_per_call": previous["device_ops_per_call"],
            },
        }
    head = out["insert_promotes"]
    return {
        "name": "compactor_cascade",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/compactor_fold.cu",
        "replaces": "metrics_tpu/ops/pallas_kernels.py:141",
        "replaces_fn": "metrics_tpu/ops/pallas_kernels.py::_make_fold_kernel -> _fold_kernel (pallas_call at :188), "
                       "with the level loops of ops/compactor.py::fold_cascade and QuantileSketchState.sketch_merge",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": head["ms"],
        "kernel_ms": head["kernel_ms"],
        "kernel_device_ms": head["kernel_device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "unit": "one cascade (a whole sketch update); the bound is per cascade",
        "shape": {"levels": L, "k": k, "M": m, "start_level": level, "timed": "insert_promotes"},
        "bytes": head["bytes"],
        "by_call": out,
        "single_fold_max_abs_err": fold_max_abs_err,
    }


def phase_k2_parity(dev):
    """K2 against its plain version on the card, bit for bit: the dist
    path's shape; sorted ids, pairs, 16-way runs, a Zipf draw and all ids in
    one bin; data pointers off the 16-byte boundary (a scalar head) and
    counts that are not a multiple of 4 (a scalar tail), down to ids in the
    head and tail alone; no ids, one id, ids out of range among valid ones
    (INT_MIN, INT_MAX, -1, num_buckets); one bucket, the JAX package's
    largest grid (8195 bins), and grids on both sides of each shared-memory
    limit of the launcher: the 48 KB default and the opt-in maximum, above
    which the bins live in device memory."""
    import torch

    from metrics_tpu_torch.ops import histogram as k2

    g = torch.Generator(device=dev).manual_seed(SEED + 6)

    def ids(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)

    out_of_range = ids(-3000, 5000, 100_003)
    out_of_range[:2] = torch.tensor([-(1 << 31), (1 << 31) - 1], dtype=torch.int32, device=dev)
    extremes = ids(0, K2_BINS, 1 << 20)
    for j, v in enumerate((-(1 << 31), (1 << 31) - 1, -1, K2_BINS)):
        extremes[j::1000] = v
    base = ids(0, K2_BINS, DIST_SHARD + 4)
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", 232_448) // 4
    default = 48 * 1024 // 4
    cases = [
        ("path_uniform", ids(0, K2_BINS, DIST_SHARD), K2_BINS),
        *((f"path_{k}", x, K2_BINS) for k, x in k2_id_patterns(dev, DIST_SHARD, K2_BINS, SEED + 9).items() if k != "uniform"),
        ("misaligned_by_1_n_2^24+3", base[1:], K2_BINS),
        ("misaligned_by_2", base[2:DIST_SHARD + 2], K2_BINS),
        ("misaligned_by_3_n_2^24+1", base[3:], K2_BINS),
        ("misaligned_head_and_tail_only_n5", base[1:6], K2_BINS),
        ("misaligned_head_only_n2", base[1:3], K2_BINS),
        ("n0", ids(0, K2_BINS, 0), K2_BINS),
        ("n1", ids(0, K2_BINS, 1), K2_BINS),
        ("n_not_a_multiple_of_the_block", ids(0, K2_BINS, 3 * 2048 + 17), K2_BINS),
        ("out_of_range", out_of_range, K2_BINS),
        ("int_min_int_max_-1_among_valid", extremes, K2_BINS),
        ("one_bucket", ids(-1, 3, 50_000), 1),
        ("bins_8195", ids(0, 8195, DIST_SHARD), 8195),
        *((f"bins_{nb}", ids(-5, nb + 5, 1 << 20), nb) for nb in (default, default + 1, optin, optin + 1)),
        ("bins_100000_global_memory", ids(-5, 100_005, 1 << 20), 100_000),
    ]
    rows, max_err = [], 0.0
    for name, x, nb in cases:
        got = k2.histogram(x, nb)
        want = k2.histogram_plain(x, nb)
        torch.cuda.synchronize()
        equal = got.dtype == want.dtype and torch.equal(got, want)
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        max_err = max(max_err, err)
        rows.append({"case": name, "n": x.shape[0], "bins": nb, "offset_bytes": x.data_ptr() % 16,
                     "counted": int(got.sum()), "bit_equal": equal})
        if not equal:
            emit({"phase": "parity", "kernel": "histogram", "cases": rows})
            raise AssertionError(f"histogram kernel differs from its plain version in case {name!r}")
    emit({"phase": "parity", "kernel": "histogram", "smem_limits_bins": [default, optin], "cases": rows, "max_abs_err": max_err})
    return max_err


def make_dist_data(device):
    """The dist path's 2^26 rows, from one seeded generator on the card:
    labels Bernoulli(0.25), float32 scores sigmoid(z + label) with z standard
    normal. Every rank makes all of them and keeps its own slice, so the
    concatenation of the shards is what the parent makes too."""
    import torch

    n = DIST_WORLD * DIST_SHARD
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    labels = (torch.rand(n, generator=g, device=device) < POSITIVE_SHARE).to(torch.int32)
    z = torch.randn(n, generator=g, device=device)
    return torch.sigmoid(z + labels.to(torch.float32)), labels


def quantized(scores):
    """Scores on a 2048-point grid, one point per histogram bucket."""
    import torch

    return torch.clamp(torch.floor(scores * QUANT_GRID), max=QUANT_GRID - 1) / QUANT_GRID


def build_dist_collection(pkg, device, ring=None):
    ring = DIST_RING if ring is None else ring
    return pkg.MetricCollection({
        "auroc": pkg.AUROC(device=device),
        "ap": pkg.AveragePrecision(device=device),
        "auroc_ring": pkg.AUROC(capacity=ring, device=device),
        "ap_ring": pkg.AveragePrecision(capacity=ring, device=device),
    })


def run_dist_batches(coll, scores, labels, sync, forward_every=DIST_FORWARD_EVERY):
    """Batches of 2^20 rows, every 8th through forward, the rest through
    update (``forward_every=None``: all through update, which accumulates
    the same state)."""
    update_s, forward_s = [], []
    for i in range(scores.shape[0] // DIST_BATCH):
        p, y = scores[i * DIST_BATCH:(i + 1) * DIST_BATCH], labels[i * DIST_BATCH:(i + 1) * DIST_BATCH]
        t0 = time.perf_counter()
        if forward_every and i % forward_every == 0:
            coll(p, y)
            sync()
            forward_s.append(time.perf_counter() - t0)
        else:
            coll.update(p, y)
            sync()
            update_s.append(time.perf_counter() - t0)
    return update_s, forward_s


def curve_digest(preds, target):
    """The exact curve's integer parts (cumulative fps and tps, and the
    thresholds): their length, last values and one sha256 over their bytes."""
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve

    fps, tps, thresholds = _binary_clf_curve(preds, target)
    h = hashlib.sha256()
    for t in (fps, tps, thresholds):
        h.update(t.cpu().numpy().tobytes())
    return {"points": int(thresholds.shape[0]), "fps_last": float(fps[-1]), "tps_last": float(tps[-1]), "sha256": h.hexdigest()}


def _bits(value):
    import torch

    return int(value.detach().reshape(()).cpu().view(torch.int32))


def dist_rank(rank, world, port, results, device):
    """One rank of the dist path, on the one card. Puts its numbers on
    ``results``; on a failure it puts the traceback and exits non-zero."""
    try:
        import torch
        import torch.distributed as dist

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            sync = torch.cuda.synchronize
        else:
            sync = lambda: None  # noqa: E731
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)

        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.ops import _build
        from metrics_tpu_torch.ops import binned_counters as k1
        from metrics_tpu_torch.ops import compactor as k3
        from metrics_tpu_torch.ops import histogram as k2
        from metrics_tpu_torch.ops.bucketed_rank import descending_order, inverse_permutation, sharded_descending_ranks
        from metrics_tpu_torch.parallel.sync import gather_all_arrays
        from metrics_tpu_torch.utilities.data import dim_zero_cat

        if dev.type == "cuda" and not _build.library_path(k2.SOURCE).exists():
            raise RuntimeError("the histogram kernel was not built before the ranks were spawned")
        out = {"rank": rank}
        scores, labels = make_dist_data(dev)
        lo, hi = rank * DIST_SHARD, (rank + 1) * DIST_SHARD
        s, y = scores[lo:hi].clone(), labels[lo:hi].clone()
        del scores, labels
        coll = build_dist_collection(mtt, dev)
        sync()
        dist.barrier()

        for kernel in (k1, k2, k3):
            kernel.reset_launch_count()
        t0 = time.perf_counter()
        update_s, forward_s = run_dist_batches(coll, s, y, sync)
        loop_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        with CollectiveRecorder() as rec:
            values = coll.compute()
            sync()
        compute_s = time.perf_counter() - t1
        out.update({
            "update_p50_ms": statistics.median(update_s) * 1e3,
            "forward_p50_ms": statistics.median(forward_s) * 1e3,
            "first_forward_ms": forward_s[0] * 1e3,
            "loop_s": loop_s,
            "compute_s": compute_s,
            "compute_collectives": {"all_reduce": rec.all_reduce, "other": rec.other},
            "peak_mem_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
            "values": {k: float(v) for k, v in values.items()},
            "value_bits": {k: _bits(v) for k, v in values.items()},
        })

        # the synced states, once more: the gather alone, and on rank 0 the
        # exact curve of the gathered rows
        members = dict(coll.items(keep_base=True, copy_state=False))
        t2 = time.perf_counter()
        with members["auroc"].sync_context(), members["auroc_ring"].sync_context():
            sync()
            out["sync_s"] = time.perf_counter() - t2
            gathered = dim_zero_cat(members["auroc"].preds)
            ring = members["auroc_ring"].metric_state["preds"]
            out["synced_rows"] = int(gathered.shape[0])
            out["synced_ring"] = {"capacity": ring.capacity, "count": int(ring.count()), "dropped": int(ring.dropped)}
            if rank == 0:
                out["curve"] = curve_digest(gathered, dim_zero_cat(members["auroc"].target))
            del gathered, ring

        # sharded ranks on the same shards: K2 once per call
        calls, sharded = 0, {}
        n = world * DIST_SHARD
        for kind, x in (("quantized", quantized(s)), ("continuous", s), ("equal", torch.full_like(s, 0.5))):
            sync()
            dist.barrier()
            t = time.perf_counter()
            ranks, resolved = sharded_descending_ranks(x)
            resolved = bool(resolved)
            hist_s = time.perf_counter() - t
            calls += 1
            t = time.perf_counter()
            want = inverse_permutation(descending_order(torch.cat(gather_all_arrays(x))))[lo:hi]
            sync()
            gathered_s = time.perf_counter() - t
            row = {"resolved": resolved, "hist_s": hist_s, "gathered_sort_s": gathered_s, "bit_equal": torch.equal(ranks, want)}
            every = torch.cat(gather_all_arrays(ranks))
            row["permutation"] = torch.equal(torch.sort(every).values, torch.arange(n, dtype=torch.int32, device=dev))
            row["rank_sum"] = int(every.to(torch.int64).sum())
            del every, want
            sharded[kind] = row
        out["sharded"] = sharded
        out["k2_calls"] = calls
        out["launches"] = {"binned_counters": k1.launch_count, "histogram": k2.launch_count, "compactor_fold": k3.launch_count}
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_world(target, label):
    """Spawn the ranks of a path (``target(rank, world, port, results,
    device)``), collect what each reports, and stop every process."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, DIST_WORLD, port, results, DIST_DEVICE)) for r in range(DIST_WORLD)]
    got = {}
    try:
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while len(got) < DIST_WORLD:
            try:
                rank, out = results.get(timeout=5)
            except queue.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs) if p.exitcode not in (None, 0)}
                if dead:
                    raise AssertionError(f"{label}: ranks exited before reporting: {dead}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"{label}: no result within {DIST_TIMEOUT_S} s")
                continue
            if "error" in out:
                raise AssertionError(f"{label}: rank {rank} failed:\n{out['error']}")
            got[rank] = out
        for proc in procs:
            proc.join(timeout=60)
        codes = [proc.exitcode for proc in procs]
        if codes != [0] * DIST_WORLD:
            raise AssertionError(f"{label}: rank exit codes {codes}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [got[r] for r in range(DIST_WORLD)]


def mann_whitney_auroc(scores, labels):
    """The exact AUROC in float64 with numpy: the positives' tie-averaged
    rank sum (every rank a multiple of 0.5, every sum exact)."""
    import numpy as np

    _, inverse, counts = np.unique(scores, return_inverse=True, return_counts=True)
    avg_rank = np.cumsum(counts) - (counts - 1) / 2.0
    pos = labels == 1
    n_pos = int(pos.sum())
    n_neg = labels.shape[0] - n_pos
    u = float(avg_rank[inverse[pos]].sum()) - n_pos * (n_pos + 1) / 2.0
    return u / (float(n_pos) * float(n_neg))


def phase_dist(dev):
    import torch

    import metrics_tpu_torch as mtt

    t0 = time.perf_counter()
    ranks = run_world(dist_rank, "dist path")
    world_s = time.perf_counter() - t0
    n = DIST_WORLD * DIST_SHARD
    batches = DIST_SHARD // DIST_BATCH

    for r in ranks:
        if r["jax_loaded"]:
            raise AssertionError(f"rank {r['rank']} loaded {r['jax_loaded']}")
        if r["value_bits"] != ranks[0]["value_bits"]:
            raise AssertionError(f"rank {r['rank']} computed {r['values']}, rank 0 {ranks[0]['values']}")
        launches = r["launches"]
        if not (launches["histogram"] == r["k2_calls"] > 0 and launches["binned_counters"] == launches["compactor_fold"] == 0):
            raise AssertionError(f"rank {r['rank']}: launches {launches} for {r['k2_calls']} sharded_descending_ranks calls")
        if r["synced_rows"] != n or r["synced_ring"] != {"capacity": n, "count": n, "dropped": 0}:
            raise AssertionError(f"rank {r['rank']}: synced {r['synced_rows']} rows and ring {r['synced_ring']}")
        sh = r["sharded"]
        if not (sh["quantized"]["resolved"] and sh["quantized"]["bit_equal"]):
            raise AssertionError(f"rank {r['rank']}: quantized ranks {sh['quantized']}")
        if not (sh["equal"]["resolved"] and sh["equal"]["rank_sum"] == n * (n - 1) // 2):
            raise AssertionError(f"rank {r['rank']}: all-equal ranks {sh['equal']}")
        if not all(row["permutation"] for row in sh.values()):
            raise AssertionError(f"rank {r['rank']}: ranks are not a permutation of 0..N-1: {sh}")
        if sh["continuous"]["resolved"] and not sh["continuous"]["bit_equal"]:
            raise AssertionError(f"rank {r['rank']}: resolved continuous ranks differ from the gathered sort")

    # the same rows through the port in one process on the CPU, all through
    # update: a ring's forward computes its batch value over the whole ring,
    # and the CPU's ring holds all 2^26 rows
    scores, labels = make_dist_data(dev)
    cs, cl = scores.cpu(), labels.cpu()
    del scores, labels
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = build_dist_collection(mtt, "cpu", ring=n)
    run_dist_batches(ref, cs, cl, lambda: None, forward_every=None)
    ref_values = ref.compute()
    cpu_s = time.perf_counter() - t1
    ref_curve = curve_digest(cs, cl)
    t2 = time.perf_counter()
    exact = mann_whitney_auroc(cs.numpy(), cl.numpy())
    exact_s = time.perf_counter() - t2

    card = ranks[0]["values"]
    rel = {k: abs(card[k] - float(v)) / abs(float(v)) for k, v in ref_values.items()}
    if ranks[0]["curve"] != ref_curve:
        raise AssertionError(f"the exact curve's parts differ: card {ranks[0]['curve']}, CPU {ref_curve}")
    if max(rel.values()) > DIST_RTOL:
        raise AssertionError(f"card {card} vs CPU {dict((k, float(v)) for k, v in ref_values.items())}: rel {rel}")
    exact_err = {k: abs(card[k] - exact) for k in ("auroc", "auroc_ring")}
    if max(exact_err.values()) > EXACT_ATOL:
        raise AssertionError(f"AUROC {card} vs exact Mann-Whitney {exact}: {exact_err}")

    q = ranks[0]["sharded"]
    emit({
        "phase": "dist_path",
        "config": {
            "world": DIST_WORLD, "rows_per_rank": DIST_SHARD, "rows": n, "batch": DIST_BATCH, "batches_per_rank": batches,
            "forward_every": DIST_FORWARD_EVERY, "ring_capacity": DIST_RING, "positive_share": POSITIVE_SHARE,
            "backend": "gloo, four processes on one card (loopback TCP; not NCCL)", "seed": SEED,
        },
        "world_s": world_s,
        "rows_per_s_per_rank": [DIST_SHARD / r["loop_s"] for r in ranks],
        "update_p50_ms": [r["update_p50_ms"] for r in ranks],
        "forward_p50_ms": [r["forward_p50_ms"] for r in ranks],
        "first_forward_ms": [r["first_forward_ms"] for r in ranks],
        "compute_s": [r["compute_s"] for r in ranks],
        # the previous transport (every member gathered its states, two
        # all_gather per tensor), for comparison: not measured in this run
        "compute_s_recorded_before_fused_sync": "4.158-4.161 (PERF.md, PR 5, call 12)",
        "compute_collectives": ranks[0]["compute_collectives"],
        "sync_two_members_s": [r["sync_s"] for r in ranks],
        "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
        "values": card,
        "cpu_values": {k: float(v) for k, v in ref_values.items()},
        "rel_diff_vs_cpu": rel,
        "exact_mann_whitney": exact,
        "abs_err_vs_exact": exact_err,
        "curve": ranks[0]["curve"],
        "curve_matches_cpu": True,
        "sharded_ranks": {
            kind: {
                "resolved": row["resolved"], "bit_equal_to_gathered_sort": row["bit_equal"],
                "hist_s_per_rank": [r["sharded"][kind]["hist_s"] for r in ranks],
                "gathered_sort_s_per_rank": [r["sharded"][kind]["gathered_sort_s"] for r in ranks],
                "rank_sum": row["rank_sum"],
            }
            for kind, row in q.items()
        },
        "k2_launches_per_rank": [r["launches"]["histogram"] for r in ranks],
        "k2_calls_per_rank": [r["k2_calls"] for r in ranks],
        "cpu_reference_s": cpu_s,
        "exact_reference_s": exact_s,
        "matches_cpu_run": True,
    })
    return sum(r["launches"]["histogram"] for r in ranks)


# ----------------------------------------------------------------------
# the fused multi-process sync: data-parallel evaluation with the fault
# channel, and sketch monitors, over the dist path's four-rank world
# ----------------------------------------------------------------------


class CollectiveRecorder:
    """Counts the collectives made through ``torch.distributed``: each
    ``all_reduce`` by its dtype and operation, and every gather."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "gather", "reduce_scatter")

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.all_reduce = []
        self.other = []
        self.sizes = []  # lanes of each all_reduce
        self.bytes = 0  # what this process sends
        self._saved = {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.dist, name)
            self._saved[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                if _name == "all_reduce":
                    op = kwargs.get("op", args[1] if len(args) > 1 else self.dist.ReduceOp.SUM)
                    self.all_reduce.append([str(args[0].dtype).replace("torch.", ""), str(op).split(".")[-1]])
                    self.sizes.append(args[0].numel())
                    self.bytes += args[0].numel() * args[0].element_size()
                else:
                    self.other.append(_name)
                    sent = args[1] if len(args) > 1 else kwargs.get("tensor")
                    if hasattr(sent, "element_size"):
                        self.bytes += sent.numel() * sent.element_size()
                return _fn(*args, **kwargs)

            setattr(self.dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.dist, name, fn)


def check_reduce_dtypes(dev, world, rank):
    """``all_reduce`` over Gloo on tensors on the card, with SUM and MAX, in
    each bucket dtype of the fused sync: int32, int64 and float32."""
    import torch
    import torch.distributed as dist

    out = {}
    for dtype in (torch.int32, torch.int64, torch.float32):
        for op in ("SUM", "MAX"):
            x = torch.arange(3, device=dev).to(dtype) + rank
            dist.all_reduce(x, op=getattr(dist.ReduceOp, op))
            want = torch.arange(3, device=dev).to(dtype) * world + sum(range(world)) if op == "SUM" else torch.arange(3, device=dev).to(dtype) + world - 1
            out[f"{str(dtype).replace('torch.', '')}_{op}"] = bool(torch.equal(x, want)) and x.device.type == dev.type
    return out


def make_fused_eval_data(device):
    """The ImageNet epoch of the main path, with faults from a seeded
    generator: 0.5 % of the rows get a NaN score, another 0.5 % the label
    ``CLASSES``."""
    import torch

    preds, target = make_data(device)
    g = torch.Generator(device=device).manual_seed(SEED + 9)
    pick = torch.rand(ROWS, generator=g, device=device)
    col = torch.randint(0, CLASSES, (ROWS,), generator=g, device=device)
    nan_rows = pick < FAULT_SHARE
    label_rows = (pick >= FAULT_SHARE) & (pick < 2 * FAULT_SHARE)
    preds[nan_rows, col[nan_rows]] = float("nan")
    target[label_rows] = CLASSES
    return preds, target, int(nan_rows.sum()), int(label_rows.sum())


def build_fused_eval(pkg, device, **sync_kw):
    kw = dict(num_classes=CLASSES, on_invalid="drop", device=device, **sync_kw)
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(**kw),
        "prec": pkg.Precision(average="macro", **kw),
        "rec": pkg.Recall(average="macro", **kw),
        "f1": pkg.F1Score(average="macro", **kw),
        "bap": pkg.BinnedAveragePrecision(thresholds=THRESHOLDS, **kw),
    })


def run_fused_eval(coll, preds, target, sync):
    """1024-row batches, the last one ragged; batch 0 through forward."""
    update_s = []
    for i, start in enumerate(range(0, preds.shape[0], BATCH)):
        p, y = preds[start:start + BATCH], target[start:start + BATCH]
        t0 = time.perf_counter()
        coll(p, y) if i == 0 else coll.update(p, y)
        sync()
        update_s.append(time.perf_counter() - t0)
    return update_s


def _values(result):
    return {k: [float(x) for x in v] if isinstance(v, list) else float(v) for k, v in result.items()}


def _rank_device(device):
    """The rank's device, and a synchronise on it."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, lambda: None
    torch.cuda.set_device(dev)
    return dev, torch.cuda.synchronize


def fused_eval_rank(rank, world, port, results, device):
    """One rank of the fused evaluation path: its quarter of the epoch."""
    try:
        import torch
        import torch.distributed as dist

        dev, sync = _rank_device(device)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.ops import binned_counters as k1
        from metrics_tpu_torch.ops import compactor as k3
        from metrics_tpu_torch.ops import histogram as k2

        out = {"rank": rank, "reduce_dtypes": check_reduce_dtypes(dev, world, rank)}
        preds, target, _, _ = make_fused_eval_data(dev)
        shard = -(-ROWS // world)
        p, y = preds[rank * shard:(rank + 1) * shard].clone(), target[rank * shard:(rank + 1) * shard].clone()
        del preds, target
        coll = build_fused_eval(mtt, dev)
        sync()
        dist.barrier()

        for kernel in (k1, k2, k3):
            kernel.reset_launch_count()
        with CollectiveRecorder() as during_updates:
            update_s = run_fused_eval(coll, p, y, sync)
        launches = {"binned_counters": k1.launch_count, "histogram": k2.launch_count, "compactor_fold": k3.launch_count}
        dist.barrier()
        t0 = time.perf_counter()
        with CollectiveRecorder() as rec:
            values = coll.compute()
            sync()
        compute_s = time.perf_counter() - t0
        members = dict(coll.items(keep_base=True, copy_state=False))
        out.update({
            "rows": int(p.shape[0]),
            "batches": len(update_s),
            "update_p50_ms": statistics.median(update_s) * 1e3,
            "compute_s": compute_s,
            "collectives_in_updates": during_updates.all_reduce + during_updates.other,
            "all_reduce": rec.all_reduce,
            "other_collectives": rec.other,
            "groups": [list(g) for g in coll.compute_groups.values()],
            "launches": launches,
            "bap_updates": members["bap"].update_count,
            "local_faults": {k: m.fault_counts for k, m in members.items()},
            "values": _values(values),
            "states_on_card": all(t.device == dev for m in members.values() for v in m.metric_state.values()
                                  for t in (v if isinstance(v, tuple) else (v,))),
        })
        # the sync alone, once more: the rest of compute() is the members' computes
        t1 = time.perf_counter()
        coll.sync_states()
        sync()
        out["sync_s"] = time.perf_counter() - t1
        out["synced_faults"] = {k: m.fault_counts for k, m in members.items()}
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def phase_fused_eval(dev):
    import torch

    import metrics_tpu_torch as mtt

    t0 = time.perf_counter()
    ranks = run_world(fused_eval_rank, "fused evaluation path")
    world_s = time.perf_counter() - t0
    preds, target, nan_rows, label_rows = make_fused_eval_data(dev)
    want_faults = {name: 0 for name in ranks[0]["synced_faults"]["acc"]}
    want_faults.update({"nonfinite_preds": nan_rows, "label_out_of_range": label_rows, "dropped_rows": nan_rows + label_rows})
    if not (nan_rows and label_rows):
        raise AssertionError(f"fused evaluation path: {nan_rows} NaN rows and {label_rows} out-of-range labels injected")

    for r in ranks:
        if r["jax_loaded"]:
            raise AssertionError(f"rank {r['rank']} loaded {r['jax_loaded']}")
        if not all(r["reduce_dtypes"].values()):
            raise AssertionError(f"rank {r['rank']}: all_reduce on the card gave wrong results: {r['reduce_dtypes']}")
        if r["collectives_in_updates"]:
            raise AssertionError(f"rank {r['rank']}: forward and update made collectives {r['collectives_in_updates']}")
        if sorted(r["all_reduce"]) != FUSED_EVAL_BUCKETS or r["other_collectives"]:
            raise AssertionError(
                f"rank {r['rank']}: compute() made all_reduce {r['all_reduce']} and {r['other_collectives']}; "
                f"predicted the buckets {FUSED_EVAL_BUCKETS}"
            )
        for name, counts in r["synced_faults"].items():
            if counts != want_faults:
                raise AssertionError(f"rank {r['rank']}: synced fault counts of {name} {counts}, injected {want_faults}")
        launches = r["launches"]
        if not (launches["binned_counters"] == r["bap_updates"] == r["batches"] and launches["histogram"] == launches["compactor_fold"] == 0):
            raise AssertionError(f"rank {r['rank']}: launches {launches} for {r['bap_updates']} bap updates over {r['batches']} batches")
        if not r["states_on_card"]:
            raise AssertionError(f"rank {r['rank']}: a state lies off the card")
        if r["values"] != ranks[0]["values"]:
            raise AssertionError(f"rank {r['rank']} computed other values than rank 0")

    # the same rows and faults through the port in one process on the CPU
    t1 = time.perf_counter()
    ref = build_fused_eval(mtt, "cpu")
    run_fused_eval(ref, preds.cpu(), target.cpu(), lambda: None)
    ref_values = _values(ref.compute())
    cpu_s = time.perf_counter() - t1
    card = ranks[0]["values"]
    if card["acc"] != ref_values["acc"]:
        raise AssertionError(f"fused evaluation path: accuracy {card['acc']} on the card, {ref_values['acc']} on the CPU")
    err = {
        k: max(abs(a - b) for a, b in zip(card[k], ref_values[k])) if isinstance(card[k], list) else abs(card[k] - ref_values[k])
        for k in card
    }
    if max(err.values()) > AP_ATOL or not all(math.isfinite(x) for v in card.values() for x in (v if isinstance(v, list) else [v])):
        raise AssertionError(f"fused evaluation path: card against CPU {err} (atol {AP_ATOL})")
    emit({
        "phase": "fused_dist_path",
        "config": {
            "world": DIST_WORLD, "rows": ROWS, "rows_per_rank": [r["rows"] for r in ranks], "classes": CLASSES,
            "batch": BATCH, "fault_share": FAULT_SHARE, "on_invalid": "drop", "seed": SEED,
            "backend": "gloo, four processes on one card (loopback TCP; not NCCL)",
        },
        "world_s": world_s,
        "compute_s": [r["compute_s"] for r in ranks],
        "sync_s": [r["sync_s"] for r in ranks],
        "update_p50_ms": [r["update_p50_ms"] for r in ranks],
        "buckets": FUSED_EVAL_BUCKETS,
        "all_reduce_per_compute": [len(r["all_reduce"]) for r in ranks],
        "all_reduce_calls": ranks[0]["all_reduce"],
        "other_collectives_per_compute": [len(r["other_collectives"]) for r in ranks],
        "compute_groups": ranks[0]["groups"],
        "reduce_dtypes_on_card": ranks[0]["reduce_dtypes"],
        "injected": {"nonfinite_preds": nan_rows, "label_out_of_range": label_rows},
        "synced_fault_counts": ranks[0]["synced_faults"]["acc"],
        "local_fault_counts_per_rank": [r["local_faults"]["acc"] for r in ranks],
        "k1_launches_per_rank": [r["launches"]["binned_counters"] for r in ranks],
        "acc": card["acc"], "prec": card["prec"], "rec": card["rec"], "f1": card["f1"],
        "bap_mean": sum(card["bap"]) / len(card["bap"]),
        "max_abs_err_vs_cpu": err,
        "cpu_reference_s": cpu_s,
        "matches_cpu_run": True,
    })
    return sum(r["launches"]["binned_counters"] for r in ranks), card


def make_rank_stream(device, rank):
    """One rank's stream: lognormal scores with NaN, +inf and -inf rows, from
    a generator seeded for the rank."""
    import torch

    n = FUSED_SKETCH_BATCHES * STREAM_BATCH
    g = torch.Generator(device=device).manual_seed(SEED + 20 + rank)
    x = torch.empty(n, device=device).log_normal_(0.0, 1.0, generator=g)
    pick = torch.rand(n, generator=g, device=device)
    third = NONFINITE_SHARE / 3
    x[pick < third] = float("nan")
    x[(pick >= third) & (pick < 2 * third)] = float("inf")
    x[(pick >= 2 * third) & (pick < NONFINITE_SHARE)] = float("-inf")
    return x


def build_fused_monitor(pkg, device):
    return pkg.MetricCollection({
        "mean": pkg.MeanMetric(nan_strategy="warn", device=device),
        "q": pkg.QuantileSketch(eps=0.01, on_invalid="drop", quantiles=(0.5, 0.99), device=device),
        "cm": pkg.CountMinSketch(depth=4, width=2048, device=device),
    })


def _host_state(state):
    """A metric's states as numpy, to put on the results queue (a tensor
    sent there would share memory with a rank that exits)."""
    return {k: ({f: t.cpu().numpy() for f, t in zip(v._fields, v)} if isinstance(v, tuple) else v.cpu().numpy()) for k, v in state.items()}


def _state_tensor(host, cls):
    """A state of ``cls`` rebuilt from :func:`_host_state`'s mapping."""
    import torch

    return cls(*(torch.from_numpy(host[f]) for f in cls._fields))


def fused_sketch_rank(rank, world, port, results, device):
    """One rank of the fused sketch path: 16 batches of 2^20 rows."""
    try:
        import torch
        import torch.distributed as dist

        dev, sync = _rank_device(device)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.ops import compactor as k3

        x = make_rank_stream(dev, rank)
        coll = build_fused_monitor(mtt, dev)
        sync()
        dist.barrier()
        k3.reset_launch_count()
        update_s = []
        with CollectiveRecorder() as during_updates:
            for i in range(FUSED_SKETCH_BATCHES):
                batch = x[i * STREAM_BATCH:(i + 1) * STREAM_BATCH]
                t0 = time.perf_counter()
                coll(batch) if i == 0 else coll.update(batch)
                sync()
                update_s.append(time.perf_counter() - t0)
        members = dict(coll.items(keep_base=True, copy_state=False))
        local = {k: _host_state(m.metric_state) for k, m in members.items()}
        insert_launches = k3.launch_count
        predicted = predicted_k3_launches(members["q"].metric_state["sketch"], STREAM_BATCH, FUSED_SKETCH_BATCHES - 1, 1)
        dist.barrier()
        t0 = time.perf_counter()
        with CollectiveRecorder() as rec:
            values = coll.compute()
            sync()
        compute_s = time.perf_counter() - t0
        sync_launches = k3.launch_count - insert_launches
        # the sync alone, once more: the rest of compute() is the members' computes
        t1 = time.perf_counter()
        coll.sync_states()
        sync()
        sync_s = time.perf_counter() - t1
        out = {
            "rank": rank,
            "update_p50_ms": statistics.median(update_s) * 1e3,
            "compute_s": compute_s,
            "sync_s": sync_s,
            "collectives_in_updates": during_updates.all_reduce + during_updates.other,
            "all_reduce": rec.all_reduce,
            "other_collectives": rec.other,
            "k3_insert_launches": insert_launches,
            "k3_insert_launches_predicted": predicted,
            "k3_sync_launches": sync_launches,
            "local": local,
            "synced": {k: _host_state(m.metric_state) for k, m in members.items()},
            "values": {k: v.cpu().numpy() for k, v in values.items()},
            "finite_sum": float(torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0).to(torch.float64).sum()),
            "finite_rows": int(torch.isfinite(x).sum()),
            "kept_sum": float(torch.where(torch.isnan(x), 0.0, x).to(torch.float64).sum()),
            "kept_rows": int((~torch.isnan(x)).sum()),
        }
        # the collection once more over the same rows with the infinities
        # made NaN (rows the mean leaves out): its mean is finite, so the
        # synced sums of the W4 merge can be held to numpy
        coll.reset()
        for i in range(FUSED_SKETCH_BATCHES):
            batch = x[i * STREAM_BATCH:(i + 1) * STREAM_BATCH]
            coll.update(torch.where(torch.isinf(batch), float("nan"), batch))
        nan_local = _host_state(members["mean"].metric_state)
        nan_mean = float(coll.compute()["mean"])
        coll.sync_states()
        out["nan_rows_local_mean"] = nan_local
        out["nan_rows_mean"] = nan_mean
        out["nan_rows_synced_mean"] = _host_state(members["mean"].metric_state)
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def phase_fused_sketch(dev):
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import compactor as k3
    from metrics_tpu_torch.utilities.guard import FaultCounters

    t0 = time.perf_counter()
    ranks = run_world(fused_sketch_rank, "fused sketch path")
    world_s = time.perf_counter() - t0
    for r in ranks:
        if r["jax_loaded"]:
            raise AssertionError(f"rank {r['rank']} loaded {r['jax_loaded']}")
        if r["collectives_in_updates"]:
            raise AssertionError(f"rank {r['rank']}: forward and update made collectives {r['collectives_in_updates']}")
        if sorted(r["all_reduce"]) != FUSED_SKETCH_BUCKETS or r["other_collectives"]:
            raise AssertionError(f"rank {r['rank']}: compute() made all_reduce {r['all_reduce']} and {r['other_collectives']}")
        if not (r["k3_insert_launches"] == r["k3_insert_launches_predicted"] > 0 and r["k3_sync_launches"] == DIST_WORLD - 1):
            raise AssertionError(
                f"rank {r['rank']}: K3 launched {r['k3_insert_launches']} times on the updates (predicted "
                f"{r['k3_insert_launches_predicted']}) and {r['k3_sync_launches']} in the sync's fold"
            )

    # the ranks' local sketches folded in rank order on the card, with K3's merge cascade
    k3.reset_launch_count()
    folded = None
    for r in ranks:
        s = mtt.QuantileSketchState(*(t.to(dev) for t in _state_tensor(r["local"]["q"]["sketch"], mtt.QuantileSketchState)))
        folded = s if folded is None else folded.sketch_merge(s)
    _rank_device(dev)[1]()
    fold_launches = k3.launch_count
    if fold_launches != DIST_WORLD - 1:
        raise AssertionError(f"the in-process fold launched K3 {fold_launches} times for {DIST_WORLD - 1} merges")
    folded = type(folded)(*(t.cpu() for t in folded))
    cm = sum(torch.from_numpy(r["local"]["cm"]["sketch"]["counts"]) for r in ranks)
    faults = {k: sum(torch.from_numpy(r["local"][k]["_faults"]["counts"]) for r in ranks) for k in ("mean", "q")}
    for r in ranks:
        q = _state_tensor(r["synced"]["q"]["sketch"], mtt.QuantileSketchState)
        # items by value: the sum in the bucket turns -0.0 into +0.0
        if not (torch.equal(q.items, folded.items) and torch.equal(q.counts, folded.counts) and int(q.n_seen) == int(folded.n_seen)):
            raise AssertionError(f"rank {r['rank']}: the synced quantile sketch differs from the in-process fold")
        if not torch.equal(torch.from_numpy(r["synced"]["cm"]["sketch"]["counts"]), cm):
            raise AssertionError(f"rank {r['rank']}: the synced CountMin counts differ from the sum of the ranks'")
        for k, want in faults.items():
            if not torch.equal(_state_tensor(r["synced"][k]["_faults"], FaultCounters).counts, want):
                raise AssertionError(f"rank {r['rank']}: synced fault counts of {k} differ from the sum of the ranks'")
        if not (r["values"]["q"] == ranks[0]["values"]["q"]).all():
            raise AssertionError(f"rank {r['rank']}: quantiles differ from rank 0's")
    finite_rows = sum(r["finite_rows"] for r in ranks)
    if int(folded.n_seen) != finite_rows:
        raise AssertionError(f"the synced sketch saw {int(folded.n_seen)} rows, the ranks hold {finite_rows} finite rows")
    dropped = int(faults["q"][5])
    if dropped != DIST_WORLD * FUSED_SKETCH_BATCHES * STREAM_BATCH - finite_rows:
        raise AssertionError(f"the quantile sketch's drop policy counted {dropped} rows")
    # the collection's means. Over the stream (NaN rows left out; it holds
    # +inf and -inf, so numpy's mean is NaN too). Over the stream with the
    # infinities made NaN, finite: float32 sums of 2^26 rows in batches,
    # merged across ranks, within MEAN_RTOL of float64, and the synced sums
    # against the ranks' local sums
    kept_mean = sum(r["kept_sum"] for r in ranks) / sum(r["kept_rows"] for r in ranks)
    synced_weight = float(ranks[0]["synced"]["mean"]["weight"])
    mean = float(ranks[0]["values"]["mean"])
    if not (math.isnan(mean) == math.isnan(kept_mean) and abs(synced_weight - sum(r["kept_rows"] for r in ranks)) <= MEAN_RTOL * synced_weight):
        raise AssertionError(f"mean {mean} (weight {synced_weight}) against numpy {kept_mean}")
    finite_mean = sum(r["finite_sum"] for r in ranks) / finite_rows
    nan_rows_mean = ranks[0]["nan_rows_mean"]
    finite_err = abs(nan_rows_mean - finite_mean) / abs(finite_mean)
    if not finite_err <= MEAN_RTOL or any(r["nan_rows_mean"] != nan_rows_mean for r in ranks):
        raise AssertionError(f"the mean over NaN rows {[r['nan_rows_mean'] for r in ranks]} against numpy {finite_mean}: rel {finite_err}")
    local_value = sum(float(r["nan_rows_local_mean"]["value"]) for r in ranks)
    local_weight = sum(float(r["nan_rows_local_mean"]["weight"]) for r in ranks)
    for r in ranks:
        value, weight = float(r["nan_rows_synced_mean"]["value"]), float(r["nan_rows_synced_mean"]["weight"])
        if not (abs(value - local_value) <= MEAN_RTOL * abs(local_value) and abs(weight - local_weight) <= MEAN_RTOL * local_weight):
            raise AssertionError(f"rank {r['rank']}: synced mean sums {value}, {weight} against the ranks' {local_value}, {local_weight}")
    emit({
        "phase": "fused_sketch_path",
        "config": {
            "world": DIST_WORLD, "batches_per_rank": FUSED_SKETCH_BATCHES, "batch": STREAM_BATCH,
            "rows": DIST_WORLD * FUSED_SKETCH_BATCHES * STREAM_BATCH, "nonfinite_share": NONFINITE_SHARE,
            "quantile_sketch": list(folded.items.shape), "count_min": list(cm.shape), "seed": SEED,
            "backend": "gloo, four processes on one card (loopback TCP; not NCCL)",
        },
        "world_s": world_s,
        "compute_s": [r["compute_s"] for r in ranks],
        "sync_s": [r["sync_s"] for r in ranks],
        "update_p50_ms": [r["update_p50_ms"] for r in ranks],
        "buckets": FUSED_SKETCH_BUCKETS,
        "all_reduce_per_compute": [len(r["all_reduce"]) for r in ranks],
        "all_reduce_calls": ranks[0]["all_reduce"],
        "other_collectives_per_compute": [len(r["other_collectives"]) for r in ranks],
        "k3_launches_per_rank": [r["k3_insert_launches"] + r["k3_sync_launches"] for r in ranks],
        "k3_fold_launches": fold_launches,
        "synced_sketch_equals_fold": True,
        "quantiles": ranks[0]["values"]["q"].tolist(),
        "n_seen": int(folded.n_seen),
        "synced_fault_counts_q": faults["q"].tolist(),
        "mean": mean if math.isfinite(mean) else str(mean),
        "mean_weight": synced_weight,
        "nan_rows_mean": nan_rows_mean,
        "nan_rows_mean_rel_err": finite_err,
    })
    return sum(r["k3_insert_launches"] + r["k3_sync_launches"] for r in ranks)


# --------------------------------------------------------------------------
# the sync layer: overlapped sync, quantized and chunked transports, the
# bounded communicator, windowed and decayed metrics
# --------------------------------------------------------------------------


def _leaves(state):
    """A state dict's tensors by name (a tuple state by ``name.field``)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, tuple):
            out.update({f"{k}.{f}": t for f, t in zip(v._fields, v)})
        elif isinstance(v, list):
            out.update({f"{k}[{i}]": t for i, t in enumerate(v)})
        else:
            out[k] = v
    return out


def _bit_equal(a, b):
    """Two lists of state dicts, tensor by tensor, bit for bit."""
    import torch

    for x, y in zip(a, b):
        lx, ly = _leaves(x), _leaves(y)
        if lx.keys() != ly.keys():
            return False
        for k in lx:
            if lx[k].dtype != ly[k].dtype or lx[k].shape != ly[k].shape:
                return False
            if lx[k].is_floating_point():
                if not torch.equal(lx[k].view(torch.int32 if lx[k].element_size() == 4 else torch.int16), ly[k].view(torch.int32 if ly[k].element_size() == 4 else torch.int16)):
                    return False
            elif not torch.equal(lx[k], ly[k]):
                return False
    return True


def _view_states(member):
    """An overlapped member's view: ``{name: state}`` of every member, after
    the view's event."""
    payload, event = member._sync_scheduler.view().payload
    if event is not None:
        event.synchronize()
    return {name: entry[0] for name, entry in payload.items()}


def _block_absmax(flat, block):
    import torch

    from metrics_tpu_torch.ops.quantize import TINY_NORMAL

    pad = (-flat.numel()) % block
    x = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, block)
    return torch.clamp_min(torch.where(torch.isfinite(x), x.abs(), torch.zeros_like(x)).amax(dim=1), TINY_NORMAL)


def _health_events(registry):
    return {k: v for k, v in registry.counts().items() if k in HEALTH_EVENTS}


def _overlapped_run(mtt, dev, sync, p, y, transport, world, members_of_blocking):
    """The fused evaluation collection with every member overlapped: the
    updates, a covered view, a read with no collective, the fresh read."""
    import torch
    import torch.distributed as dist

    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import compactor as k3
    from metrics_tpu_torch.ops import histogram as k2
    from metrics_tpu_torch.ops.quantize import DEFAULT_BLOCK, MAX_CODE, resolve_codec
    from metrics_tpu_torch.parallel.sync import fused_sync
    from metrics_tpu_torch.resilience.health import health_report, registry

    coll = build_fused_eval(mtt, dev, sync_mode="overlapped", sync_every_n=SYNC_EVERY_N, sync_transport=transport)
    sync()
    dist.barrier()
    for kernel in (k1, k2, k3):
        kernel.reset_launch_count()
    with CollectiveRecorder() as during_updates:
        update_s = run_fused_eval(coll, p, y, sync)
    launches = {"binned_counters": k1.launch_count, "histogram": k2.launch_count, "compactor_fold": k3.launch_count}
    members = dict(coll.items(keep_base=True, copy_state=False))
    covered = members["acc"].request_sync(wait=True, deadline_s=120.0)
    sync()
    sched = members["acc"]._sync_scheduler
    cycles = {"cycles": sched.cycles, "cycle_ms": sched.cycle_s / max(sched.cycles, 1) * 1e3,
              "producers_blocked_s": sched.blocked_s, "notifies": sched.seq()}
    t0 = time.perf_counter()
    with CollectiveRecorder() as rec:
        values = _values(coll.compute())
        sync()
    read_s = time.perf_counter() - t0
    report = health_report(coll)
    view = _view_states(members["acc"])
    names = list(members)
    live = [members[k]._state for k in names]
    reds = [members[k]._reductions for k in names]
    defaults = [members[k]._sync_defaults() for k in names]
    exact = fused_sync(live, reds, None, defaults, transport="exact")
    # one cycle's bytes: the same sync on the same states, recorded
    with CollectiveRecorder() as wire:
        fused_sync(live, reds, None, defaults, transport="exact", host_codec=resolve_codec(transport))
    with CollectiveRecorder() as exact_wire:
        fused_sync(live, reds, None, defaults, transport="exact")
    dist.barrier()
    t1 = time.perf_counter()
    fresh = _values(coll.compute(fresh=True))
    sync()
    fresh_s = time.perf_counter() - t1
    out = {
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "updates_s": sum(update_s),
        "collectives_in_updates": len(during_updates.all_reduce + during_updates.other),
        **cycles,
        "covered": covered,
        "read_collectives": rec.all_reduce + rec.other,
        "read_s": read_s,
        "fresh_s": fresh_s,
        "values": values,
        "fresh_values": fresh,
        "launches": launches,
        "bap_updates": members["bap"].update_count,
        "degradation_events": sorted(set(report["event_counts"]) - set(report["informational_event_kinds"])),
        "degraded_by": sorted({k for e in report["metrics"].values() for k in ("faults", "overflow_dropped") if k in e}),
        "sync_lag_steps": {k: e.get("sync_lag_steps") for k, e in report["metrics"].items()},
        "view_equals_exact": _bit_equal([view[k] for k in names], exact),
        "wire_bytes": wire.bytes,
        "exact_bytes": exact_wire.bytes,
        "wire_collectives": wire.all_reduce + wire.other,
    }
    # the int8 envelope of BAP's float32 counters: each lane within the sum
    # over ranks of its block's absmax / (2 * 126), plus the float32
    # roundings of each rank's decode and of the rank-order sum (the
    # difference is taken in float64)
    worst = 0.0
    for key in ("TPs", "FPs", "FNs"):
        local = members["bap"]._state[key].reshape(-1)
        absmax = _block_absmax(local, DEFAULT_BLOCK)
        parts = [torch.empty_like(absmax) for _ in range(world)]
        dist.all_gather(parts, absmax)
        per_block = torch.stack(parts).sum(0) / (2 * MAX_CODE)
        bound = per_block.repeat_interleave(DEFAULT_BLOCK)[: local.numel()].double()
        got = view["bap"][key].reshape(-1).double()
        want = exact[names.index("bap")][key].reshape(-1).double()
        bound = bound + world * DECODE_ROUNDING * (want.abs() + bound)
        worst = max(worst, float(((got - want).abs() / bound).max()))
    out["bap_err_over_bound"] = worst
    out["bap_max_abs_err"] = max(float((view["bap"][k] - exact[names.index("bap")][k]).abs().max()) for k in ("TPs", "FPs", "FNs"))
    out["int_lanes_bit_equal"] = all(
        torch.equal(a, b)
        for i, k in enumerate(names)
        for leaf, a in _leaves(view[k]).items()
        for b in [_leaves(exact[i])[leaf]]
        if not a.is_floating_point()
    )
    out["events"] = _health_events(registry)
    coll.reset()
    return out


def sync_layer_rank(rank, world, port, results, device):
    """One rank of the sync layer's world: the overlapped evaluation (exact,
    then int8), the quantized sketch sync (int8, then fp16), the chunked
    schedule and the bounded communicator over the healthy world."""
    try:
        import torch
        import torch.distributed as dist

        dev, sync = _rank_device(device)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.ops import compactor as k3
        from metrics_tpu_torch.ops.quantize import resolve_codec
        from metrics_tpu_torch.parallel.sync import RetryingGather, fused_sync
        from metrics_tpu_torch.resilience.health import registry

        out = {"rank": rank}
        preds, target, _, _ = make_fused_eval_data(dev)
        shard = -(-ROWS // world)
        p, y = preds[rank * shard:(rank + 1) * shard].clone(), target[rank * shard:(rank + 1) * shard].clone()
        del preds, target

        # the blocking collection, for the update p50 of the same world
        blocking = build_fused_eval(mtt, dev)
        sync()
        dist.barrier()
        out["blocking_update_p50_ms"] = statistics.median(run_fused_eval(blocking, p, y, sync)) * 1e3
        bmembers = dict(blocking.items(keep_base=True, copy_state=False))
        out["blocking_values"] = _values(blocking.compute())
        out["overlapped"] = {t: _overlapped_run(mtt, dev, sync, p, y, t, world, bmembers) for t in ("exact", "int8")}

        # the chunked schedule on the evaluation collection's states
        names = list(bmembers)
        states = [bmembers[k]._state for k in names]
        reds = [bmembers[k]._reductions for k in names]
        defaults = [bmembers[k]._sync_defaults() for k in names]
        chunked = {}
        synced = {}
        for chunks in (1, SYNC_CHUNKS):
            dist.barrier()
            t0 = time.perf_counter()
            with CollectiveRecorder() as rec:
                synced[chunks] = fused_sync(states, reds, None, defaults, transport="exact", chunks=chunks)
                sync()
            chunked[chunks] = {"sync_s": time.perf_counter() - t0, "all_reduce": rec.all_reduce, "sizes": rec.sizes, "other": rec.other}
        out["chunked"] = {
            "by_chunks": chunked,
            "bit_equal": _bit_equal(synced[1], synced[SYNC_CHUNKS]),
            "predicted_all_reduce": sum(min(SYNC_CHUNKS, n) for n in chunked[1]["sizes"]),
        }

        # the bounded communicator over the healthy world
        # (timed in turns: plain, bounded, bounded, plain)
        bounded = RetryingGather(dist)
        times = {"plain": [], "bounded": []}
        for kind in ("plain", "bounded", "bounded", "plain"):
            dist.barrier()
            t0 = time.perf_counter()
            synced_once = fused_sync(states, reds, None, defaults, comm=dist if kind == "plain" else bounded, transport="exact")
            sync()
            times[kind].append(time.perf_counter() - t0)
            if kind == "plain":
                plain = synced_once
            else:
                retried = synced_once
        out["retry_healthy"] = {"bit_equal": _bit_equal(plain, retried), "events": _health_events(registry), "sync_s": times}
        del blocking, bmembers, states, synced, plain, retried, p, y
        torch.cuda.empty_cache()

        # the sketch monitor through the quantized transports
        x = make_rank_stream(dev, rank)
        mon = build_fused_monitor(mtt, dev)
        for i in range(FUSED_SKETCH_BATCHES):
            batch = x[i * STREAM_BATCH:(i + 1) * STREAM_BATCH]
            mon(batch) if i == 0 else mon.update(batch)
        del x
        mm = dict(mon.items(keep_base=True, copy_state=False))
        names = list(mm)
        states = [mm[k]._state for k in names]
        reds = [mm[k]._reductions for k in names]
        defaults = [mm[k]._sync_defaults() for k in names]
        qi = names.index("q")
        exact = fused_sync(states, reds, None, defaults, transport="exact")
        qs = (0.5, 0.99)
        sketch = {"exact_quantiles": exact[qi]["sketch"].quantile(qs).tolist()}
        local = states[qi]["sketch"]
        packed, tail = local.pack(), local.counts.shape[0] + 2
        for transport in ("int8", "fp16"):
            codec = resolve_codec(transport)
            dist.barrier()
            k3.reset_launch_count()
            t0 = time.perf_counter()
            with CollectiveRecorder() as rec:
                got = fused_sync(states, reds, None, defaults, transport=transport)
                sync()
            seconds = time.perf_counter() - t0
            launches = k3.launch_count
            # this rank's payload through the wire: the item lanes within the
            # codec's envelope, the tail bit-exact
            dec = codec.decode(codec.encode(packed, tail), packed.numel(), tail)
            head = packed[: packed.numel() - tail]
            finite = torch.isfinite(head)
            absmax = _block_absmax(head, 32).repeat_interleave(32)[: head.numel()].double()
            h64 = torch.where(finite, head, torch.zeros_like(head)).double()
            if transport == "int8":
                bound = absmax / 252
            else:
                bound = torch.maximum(h64.abs() * 2.0 ** -10, absmax * 2.0 ** -24)
            bound = bound + DECODE_ROUNDING * h64.abs()
            err = torch.where(finite, dec[: head.numel()].double() - h64, torch.zeros_like(h64)).abs()
            specials = torch.equal(torch.isnan(dec[: head.numel()]), torch.isnan(head)) and torch.equal(torch.isinf(dec[: head.numel()]), torch.isinf(head))
            sketch[transport] = {
                "sync_s": seconds,
                "all_reduce": rec.all_reduce,
                "other": rec.other,
                "bytes": rec.bytes,
                "k3_merge_launches": launches,
                "counts_equal": torch.equal(got[qi]["sketch"].counts, exact[qi]["sketch"].counts),
                "n_seen_equal": int(got[qi]["sketch"].n_seen) == int(exact[qi]["sketch"].n_seen),
                "cm_equal": torch.equal(got[names.index("cm")]["sketch"].counts, exact[names.index("cm")]["sketch"].counts),
                "faults_equal": all(torch.equal(got[i]["_faults"].counts, exact[i]["_faults"].counts) for i, k in enumerate(names) if "_faults" in exact[i]),
                "item_err_over_bound": float((err / bound).max()),
                "tail_bit_equal": torch.equal(dec[head.numel():].view(torch.int32), packed[head.numel():].view(torch.int32)),
                "specials_kept": specials,
                "quantiles": got[qi]["sketch"].quantile(qs).tolist(),
                "mean_sums": [float(got[names.index("mean")][k]) for k in ("value", "weight")],
            }
        with CollectiveRecorder() as rec:
            fused_sync(states, reds, None, defaults, transport="exact")
        sketch["exact_bytes"] = rec.bytes
        sketch["exact_mean_sums"] = [float(exact[names.index("mean")][k]) for k in ("value", "weight")]
        out["sketch"] = sketch
        out["events"] = _health_events(registry)
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


class _WedgedWorld:
    """A world of ``DIST_WORLD`` ranks whose collectives never return: a
    peer that hangs."""

    def get_world_size(self, group=None):
        return DIST_WORLD

    def get_rank(self, group=None):
        return 0

    def all_reduce(self, tensor, op=None, group=None):
        time.sleep(3600)

    def all_gather(self, parts, tensor, group=None):
        time.sleep(3600)


def retry_wedged(dev):
    """The bounded communicator against a wedged peer, in this process: a
    sync of the evaluation collection's states degrades to the local value
    within the timeout, records one ``gather_degraded``, and the next sync
    returns at once while the breaker is open."""
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.parallel.sync import _WORLD_OF_ONE, RetryingGather, fused_sync
    from metrics_tpu_torch.resilience.health import registry

    preds, target, _, _ = make_fused_eval_data(dev)
    coll = build_fused_eval(mtt, dev)
    run_fused_eval(coll, preds[:4096], target[:4096], torch.cuda.synchronize)
    members = dict(coll.items(keep_base=True, copy_state=False))
    states = [m._state for m in members.values()]
    reds = [m._reductions for m in members.values()]
    defaults = [m._sync_defaults() for m in members.values()]
    registry.clear()
    comm = RetryingGather(_WedgedWorld(), timeout_s=RETRY_TIMEOUT_S)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        got = fused_sync(states, reds, None, defaults, comm=comm, transport="exact")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        again = fused_sync(states, reds, None, defaults, comm=comm, transport="exact")
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t1
    local = fused_sync(states, reds, None, defaults, comm=_WORLD_OF_ONE, transport="exact")
    events = dict(registry.counts())
    out = {
        "timeout_s": RETRY_TIMEOUT_S,
        "degraded_call_s": first_s,
        "breaker_open_call_s": second_s,
        "events": events,
        "local_values": _bit_equal(got, local) and _bit_equal(again, local),
    }
    if not (first_s <= RETRY_TIMEOUT_S + RETRY_SLACK_S and second_s < BREAKER_FAST_S and events == {"gather_degraded": 1} and out["local_values"]):
        raise AssertionError(f"retry: the wedged world gave {out}")
    registry.clear()
    return out


def phase_sync_layer(dev, fused_values):
    """The four-rank world of the sync layer, then the wedged transport in
    this process; emits the phases overlapped_path, quantized_sketch_path,
    chunked_sync and retry."""
    t0 = time.perf_counter()
    ranks = run_world(sync_layer_rank, "sync layer")
    world_s = time.perf_counter() - t0
    for r in ranks:
        if r["jax_loaded"]:
            raise AssertionError(f"rank {r['rank']} loaded {r['jax_loaded']}")
        if r["events"] or any(o["events"] for o in r["overlapped"].values()) or r["retry_healthy"]["events"]:
            raise AssertionError(f"rank {r['rank']}: health events in a healthy world: {r['events']}, {[o['events'] for o in r['overlapped'].values()]}")
        for transport, o in r["overlapped"].items():
            where = f"rank {r['rank']}, overlapped {transport}"
            if not o["covered"] or o["read_collectives"]:
                raise AssertionError(f"{where}: covered {o['covered']}, the read made {o['read_collectives']}")
            # the path injects faults, which health_report counts as
            # degraded by the JAX package's own rule; the sync must add none
            if o["degradation_events"] or any(v != 0 for v in o["sync_lag_steps"].values()) or o["degraded_by"] != ["faults"]:
                raise AssertionError(f"{where}: events {o['degradation_events']}, lag {o['sync_lag_steps']}, degraded by {o['degraded_by']}")
            launches = o["launches"]
            if not (launches["binned_counters"] == o["bap_updates"] > 0 and launches["histogram"] == launches["compactor_fold"] == 0):
                raise AssertionError(f"{where}: launches {launches} for {o['bap_updates']} bap updates")
            if o["fresh_values"] != r["blocking_values"]:
                raise AssertionError(f"{where}: compute(fresh=True) differs from the blocking collection")
            if not o["int_lanes_bit_equal"]:
                raise AssertionError(f"{where}: integer or fault lanes of the view differ from the exact sync")
        ex, q8 = r["overlapped"]["exact"], r["overlapped"]["int8"]
        if not (ex["view_equals_exact"] and ex["values"] == ex["fresh_values"] == fused_values):
            raise AssertionError(f"rank {r['rank']}: the exact overlapped read differs from the blocking read or fused_dist_path")
        if not q8["bap_err_over_bound"] <= 1.0:
            raise AssertionError(f"rank {r['rank']}: int8 BAP lanes at {q8['bap_err_over_bound']} of their bound")
        if any(q8["values"][k] != ex["values"][k] for k in ("acc", "prec", "rec", "f1")):
            raise AssertionError(f"rank {r['rank']}: int8 changed members without float leaves")
        c = r["chunked"]
        if not (c["bit_equal"] and len(c["by_chunks"][SYNC_CHUNKS]["all_reduce"]) == c["predicted_all_reduce"] and not c["by_chunks"][SYNC_CHUNKS]["other"]):
            raise AssertionError(f"rank {r['rank']}: chunked sync {c}")
        if not r["retry_healthy"]["bit_equal"]:
            raise AssertionError(f"rank {r['rank']}: the bounded communicator changed the synced values")
        for transport in ("int8", "fp16"):
            sk = r["sketch"][transport]
            checks = ("counts_equal", "n_seen_equal", "cm_equal", "faults_equal", "tail_bit_equal", "specials_kept")
            if not all(sk[c] for c in checks) or sk["item_err_over_bound"] > 1.0 or sk["k3_merge_launches"] != DIST_WORLD - 1 or sk["other"] != ["all_gather"]:
                raise AssertionError(f"rank {r['rank']}: {transport} sketch sync {sk}")
        if r["overlapped"]["exact"]["values"] != ranks[0]["overlapped"]["exact"]["values"]:
            raise AssertionError(f"rank {r['rank']} read other values than rank 0")
    wedged = retry_wedged(dev)
    backend = "gloo, four processes on one card (loopback TCP; not NCCL)"
    r0 = ranks[0]
    emit({
        "phase": "overlapped_path",
        "config": {"world": DIST_WORLD, "rows": ROWS, "classes": CLASSES, "sync_every_n": SYNC_EVERY_N, "backend": backend},
        "world_s": world_s,
        "update_p50_ms": {t: [r["overlapped"][t]["update_p50_ms"] for r in ranks] for t in ("exact", "int8")},
        "blocking_update_p50_ms": [r["blocking_update_p50_ms"] for r in ranks],
        "read_s": {t: [r["overlapped"][t]["read_s"] for r in ranks] for t in ("exact", "int8")},
        "fresh_s": {t: [r["overlapped"][t]["fresh_s"] for r in ranks] for t in ("exact", "int8")},
        "read_collectives": 0,
        "cycles": {t: [{k: r["overlapped"][t][k] for k in ("notifies", "cycles", "cycle_ms", "producers_blocked_s", "updates_s")} for r in ranks] for t in ("exact", "int8")},
        "cycle_bytes_per_rank": {"exact": r0["overlapped"]["exact"]["exact_bytes"], "int8": r0["overlapped"]["int8"]["wire_bytes"]},
        "int8_cycle_collectives": r0["overlapped"]["int8"]["wire_collectives"],
        "exact_equals_blocking_and_fused_dist_path": True,
        "int8_bap_err_over_bound": [r["overlapped"]["int8"]["bap_err_over_bound"] for r in ranks],
        "int8_bap_max_abs_err": [r["overlapped"]["int8"]["bap_max_abs_err"] for r in ranks],
        "int8_bap_mean": sum(r0["overlapped"]["int8"]["values"]["bap"]) / CLASSES,
        "exact_bap_mean": sum(r0["overlapped"]["exact"]["values"]["bap"]) / CLASSES,
        "acc": r0["overlapped"]["exact"]["values"]["acc"],
        "k1_launches_per_rank": [r["overlapped"]["exact"]["launches"]["binned_counters"] + r["overlapped"]["int8"]["launches"]["binned_counters"] for r in ranks],
        "health_degradation_events": [],
        "health_degraded_by": ["faults"],
    })
    emit({
        "phase": "quantized_sketch_path",
        "config": {"world": DIST_WORLD, "batches_per_rank": FUSED_SKETCH_BATCHES, "batch": STREAM_BATCH, "backend": backend},
        "exact_quantiles": r0["sketch"]["exact_quantiles"],
        "exact_bytes_per_rank": r0["sketch"]["exact_bytes"],
        "exact_mean_sums": [x if math.isfinite(x) else str(x) for x in r0["sketch"]["exact_mean_sums"]],
        **{t: {
            "quantiles": r0["sketch"][t]["quantiles"],
            "bytes_per_rank": r0["sketch"][t]["bytes"],
            "sync_s": [r["sketch"][t]["sync_s"] for r in ranks],
            "all_reduce": r0["sketch"][t]["all_reduce"],
            "other": r0["sketch"][t]["other"],
            "item_err_over_bound": max(r["sketch"][t]["item_err_over_bound"] for r in ranks),
            "k3_merge_launches_per_rank": [r["sketch"][t]["k3_merge_launches"] for r in ranks],
            "mean_sums": [x if math.isfinite(x) else str(x) for x in r0["sketch"][t]["mean_sums"]],
        } for t in ("int8", "fp16")},
        "counts_n_seen_cm_faults_bit_equal": True,
    })
    emit({
        "phase": "chunked_sync",
        "chunks": SYNC_CHUNKS,
        "sync_s": {str(k): [r["chunked"]["by_chunks"][k]["sync_s"] for r in ranks] for k in (1, SYNC_CHUNKS)},
        "all_reduce_calls": {str(k): len(r0["chunked"]["by_chunks"][k]["all_reduce"]) for k in (1, SYNC_CHUNKS)},
        "predicted_all_reduce": r0["chunked"]["predicted_all_reduce"],
        "bucket_lanes": r0["chunked"]["by_chunks"][1]["sizes"],
        "bit_equal": True,
    })
    emit({"phase": "retry", "healthy_bit_equal": True, "healthy_events": {},
          "healthy_sync_s": {k: [t for r in ranks for t in r["retry_healthy"]["sync_s"][k]] for k in ("plain", "bounded")}, **wedged})
    k1 = sum(r["overlapped"][t]["launches"]["binned_counters"] for r in ranks for t in ("exact", "int8"))
    k3 = sum(r["sketch"][t]["k3_merge_launches"] for r in ranks for t in ("int8", "fp16"))
    return k1, k3


def phase_windowed(preds, target):
    """A trailing window of accuracy and a decayed mean of top-1 correctness
    over the epoch's full batches, on the card and on the CPU."""
    import torch

    import metrics_tpu_torch as mtt

    full = (ROWS // BATCH) * BATCH
    correct = (preds[:full].argmax(dim=1) == target[:full]).to(torch.float32)
    out = {}
    card = preds.device.type
    for device in (card, "cpu"):
        win = mtt.WindowedMetric(mtt.Accuracy(num_classes=CLASSES, device=device), window=WINDOW, buckets=WINDOW_BUCKETS)
        dec = mtt.DecayedMetric(mtt.MeanMetric(device=device), halflife=HALFLIFE)
        t0 = time.perf_counter()
        for start in range(0, full, BATCH):
            win.update(preds[start:start + BATCH].to(device), target[start:start + BATCH].to(device))
            dec.update(correct[start:start + BATCH].to(device))
        if device == "cuda":
            torch.cuda.synchronize()
        out["card" if device == card and "card" not in out else "cpu"] = {"seconds": time.perf_counter() - t0, "window": float(win.compute()), "window_rows": win.window_rows,
                       "decayed": float(dec.compute())}
    trailing = mtt.Accuracy(num_classes=CLASSES, device=card)
    trailing.update(preds[full - WINDOW:full], target[full - WINDOW:full])
    want = float(trailing.compute())
    batches = full // BATCH
    c64 = correct.cpu().to(torch.float64).reshape(batches, BATCH).sum(dim=1)
    after = torch.arange(batches - 1, -1, -1, dtype=torch.float64) * BATCH
    w = torch.exp2(-after / HALFLIFE)
    closed = float((w * c64).sum() / (w * BATCH).sum())
    card, cpu = out["card"], out["cpu"]
    rel = abs(card["decayed"] - closed) / abs(closed)
    if not (card["window_rows"] == WINDOW == cpu["window_rows"] and card["window"] == want == cpu["window"]):
        raise AssertionError(f"windowed_path: window {card}, {cpu} against the trailing {WINDOW} rows' {want}")
    if not (rel <= MEAN_RTOL and abs(card["decayed"] - cpu["decayed"]) <= MEAN_RTOL * abs(cpu["decayed"])):
        raise AssertionError(f"windowed_path: decayed {card['decayed']} (CPU {cpu['decayed']}) against {closed}")
    emit({
        "phase": "windowed_path",
        "config": {"rows": full, "batch": BATCH, "window": WINDOW, "buckets": WINDOW_BUCKETS, "halflife": HALFLIFE},
        "window_accuracy": card["window"], "trailing_accuracy": want, "window_rows": card["window_rows"],
        "decayed_mean": card["decayed"], "decayed_mean_cpu": cpu["decayed"], "closed_form": closed, "rel_err": rel,
        "card_s": card["seconds"], "cpu_s": cpu["seconds"], "matches_cpu_run": True,
    })


def k2_id_patterns(dev, n, nb, seed):
    """Id patterns for K2 at ``n`` ids over ``nb`` bins: uniform, sorted
    uniform, all in one bin, pairs and 16-way runs of consecutive ids, and
    a Zipf(1.1) draw whose first bins are hot."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    i = torch.arange(n, device=dev, dtype=torch.int64)
    uniform = torch.randint(0, nb, (n,), generator=g, device=dev, dtype=torch.int32)
    weights = torch.arange(1, nb + 1, device=dev, dtype=torch.float64) ** -1.1
    cdf = torch.cumsum(weights, 0) / weights.sum()
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    return {
        "uniform": uniform,
        "sorted": torch.sort(uniform).values,
        "all_equal": torch.full((n,), 1, dtype=torch.int32, device=dev),
        "pairs": ((i // 2) % nb).to(torch.int32),
        "runs_16": ((i // 16) % nb).to(torch.int32),
        "zipf": torch.clamp(torch.searchsorted(cdf, u), max=nb - 1).to(torch.int32),
    }


def _match_library():
    """K2's previous design (csrc/histogram_match.cu)."""
    from metrics_tpu_torch.ops import _build

    lib = _build.load(MATCH_SOURCE)
    lib.histogram_match_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.histogram_match_launch.restype = ctypes.c_int
    return lib


def _match_fn(lib, ids, nb, out, stream):
    """One launch of the previous design into ``out``, which it zeroes first."""
    def run():
        out.zero_()
        err = lib.histogram_match_launch(ids.data_ptr(), ids.shape[0], nb, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"histogram_match launch failed with cudaError {err}")
    return run


def k2_times(dev, max_abs_err):
    """K2's entry of the kernels line, at the dist path's shape (2^24 ids of
    one rank, 2051 bins), beside its previous design (csrc/histogram_match.cu)
    timed in the same run: uniform ids, all ids in one bin, sorted uniform
    ids, and the bucket ids of rank 0's quantized and continuous scores.
    Timed before any path spawns its ranks: after that, the profiler has
    kept the card's records of too few launches (620 of 800). The dist
    path's launches come in later (:func:`k2_path_launches`)."""
    import torch

    from metrics_tpu_torch.ops import histogram as k2
    from metrics_tpu_torch.ops.bucketed_rank import bucket_counts

    n, nb = DIST_SHARD, K2_BINS
    patterns = k2_id_patterns(dev, n, nb, SEED + 8)
    scores = make_dist_data(dev)[0]  # all 2^26 rows: their bounds are what the ranks' all_reduce gives
    q = quantized(scores)
    inputs = {
        "uniform": patterns["uniform"],
        "all_equal": patterns["all_equal"],
        "sorted": patterns["sorted"],
        "path_ids": bucket_counts(q[:n], q.min(), q.max(), NUM_BUCKETS)[1].contiguous(),
        "path_continuous": bucket_counts(scores[:n], scores.min(), scores.max(), NUM_BUCKETS)[1].contiguous(),
    }
    del q, scores
    lib = k2._library()
    prev_lib = _match_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.zeros(nb, dtype=torch.int32, device=dev)
    prev_out = torch.zeros(nb, dtype=torch.int32, device=dev)

    def kernel_fn(ids, zero=True):
        def run():
            if zero:
                out.zero_()
            err = lib.histogram_launch(ids.data_ptr(), ids.shape[0], nb, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"histogram launch failed with cudaError {err}")
        return run

    bytes_moved = 4 * n + 4 * nb  # int32 ids in, int32 counts out
    ops = n  # one add per id
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    per_input = {}
    for name, ids in inputs.items():
        raw, prev = kernel_fn(ids), _match_fn(prev_lib, ids, nb, prev_out, stream)
        raw()
        prev()
        if not torch.equal(out, prev_out):
            raise AssertionError(f"the previous K2 design and the kernel disagree on input {name!r}")
        fns = {
            "kernel": raw,
            "prev_kernel": prev,
            "wrapper": lambda ids=ids: k2.histogram(ids, nb),
            "plain": lambda ids=ids: k2.histogram_plain(ids, nb),
            "library": lambda ids=ids: torch.bincount(ids, minlength=nb),
        }
        # in turns, so drift on the card touches every version alike
        order = ["plain", "prev_kernel", "wrapper", "kernel", "library", "library", "kernel", "wrapper", "prev_kernel", "plain"]
        times = {}
        for label in order:
            times.setdefault(label, []).append(cuda_time_ms(fns[label]))
        ms = {label: statistics.mean(v) for label, v in times.items()}
        ms["kernel_device"] = device_ms_per_launch(raw, "histogram_kernel")
        # kernels that one call of the launcher puts on the card, from the launches on the host
        ms["kernels_per_call"] = device_profile(kernel_fn(ids, zero=False), "histogram_kernel")["host_launches_per_call"]
        if ms["kernels_per_call"] != 1.0:
            raise AssertionError(f"one histogram call launched {ms['kernels_per_call']} kernels on input {name!r}, not 1")
        ms["prev_kernel_device"] = device_ms_per_launch(prev, "histogram_match_kernel")
        ms["library_device"] = device_profile(fns["library"], "")["all_device_ms_per_call"]
        ms["kernel_vs_prev"] = ms["kernel_device"] / ms["prev_kernel_device"]
        ms["kernel_vs_library"] = ms["kernel_device"] / ms["library_device"]
        ms["share_of_bound"] = bound_ms / ms["kernel_device"]
        per_input[name] = ms

    head = per_input["uniform"]
    return {
        "name": "histogram",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/histogram.cu",
        "replaces": "metrics_tpu/ops/pallas_kernels.py:62",
        "replaces_fn": "metrics_tpu/ops/pallas_kernels.py::_histogram_kernel (pallas_call at :92)",
        "kernels_per_call": head["kernels_per_call"],
        "max_abs_err": max_abs_err,
        "ms": head["wrapper"],
        "kernel_ms": head["kernel"],
        "kernel_device_ms": head["kernel_device"],
        "plain_ms": head["plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": head["library"],
        "library_call": "torch.bincount(ids, minlength=2051)",
        "by_input": per_input,
        "previous_design": "csrc/histogram_match.cu (a warp match per id, scalar loads, two blocks per SM), timed in this run",
        "shape": {"n": n, "bins": nb},
        "bytes": bytes_moved,
    }


# ---------------------------------------------------------------------------
# the rest of classification: the confusion-matrix family (K2), calibration,
# hinge, KL, multilabel ranking and metric arithmetic
# ---------------------------------------------------------------------------


def build_full_classification(pkg, device, bap=True):
    """The ImageNet-1k evaluation with every classification metric of the
    port: the confusion-matrix family as one compute group (one K2 count per
    batch), specificity and Dice as another, calibration, hinge, an F1 built
    as metric arithmetic, and BAP (K1) unless ``bap`` is false. The groups
    are declared, so that the first batch, too, counts the confusion matrix
    once."""
    p = pkg.Precision(num_classes=CLASSES, average="macro", device=device)
    r = pkg.Recall(num_classes=CLASSES, average="macro", device=device)
    members = {
        "cm": pkg.ConfusionMatrix(CLASSES, device=device),
        "kappa": pkg.CohenKappa(CLASSES, device=device),
        "mcc": pkg.MatthewsCorrCoef(CLASSES, device=device),
        "jaccard": pkg.JaccardIndex(CLASSES, device=device),
        "spec": pkg.Specificity(num_classes=CLASSES, average="macro", device=device),
        "dice": pkg.Dice(num_classes=CLASSES, average="macro", device=device),
        "hamming": pkg.HammingDistance(device=device),
        # binned: (n_bins,) sum states, so a sync makes no gather
        "ce": pkg.CalibrationError(n_bins=CE_BINS, binned=True, device=device),
        "hinge": pkg.HingeLoss(multiclass_mode="crammer-singer", device=device),
        "f1": 2 * p * r / (p + r),
    }
    if not bap:
        return pkg.MetricCollection(members, compute_groups=[g for g in FULL_GROUPS if g != ["bap"]])
    members["bap"] = pkg.BinnedAveragePrecision(num_classes=CLASSES, thresholds=THRESHOLDS, device=device)
    return pkg.MetricCollection(members, compute_groups=FULL_GROUPS)


def make_second_model(device):
    """The class distributions of a second seeded model over the epoch, for
    KL(first model || second model)."""
    import torch

    _, target = make_data(device)
    g = torch.Generator(device=device).manual_seed(SEED + 21)
    logits = torch.randn((ROWS, CLASSES), generator=g, device=device)
    logits[torch.arange(ROWS, device=device), target] += SIGNAL / 2
    return torch.softmax(logits, dim=1)


def run_full_classification(coll, kl, preds, target, q, sync, rows=None):
    """Update-only 1024-row batches (the last one ragged); returns per-update seconds."""
    update_s = []
    for start in range(0, preds.shape[0] if rows is None else rows, BATCH):
        p, y = preds[start:start + BATCH], target[start:start + BATCH]
        t0 = time.perf_counter()
        coll.update(p, y)
        if kl is not None:
            kl.update(p, q[start:start + BATCH])
        sync()
        update_s.append(time.perf_counter() - t0)
    return update_s


def _full_values(result):
    """Floats of a full-classification result; the confusion matrix as an array."""
    out = {}
    for k, v in result.items():
        if k == "cm":
            out[k] = v.cpu()
        elif isinstance(v, list):
            out[k] = [float(x) for x in v]
        else:
            out[k] = float(v)
    return out


def compare_full_values(card, cpu, what):
    """The card's values against the CPU run's: the confusion matrix bit-equal,
    values from counts within AP_ATOL, float32 sums of the epoch's rows
    within FLOAT_SUM_RTOL; returns the largest differences."""
    import torch

    if not torch.equal(card["cm"], cpu["cm"]):
        raise AssertionError(f"{what}: the confusion matrix differs from the CPU run")
    err = {}
    for k in card:
        if k == "cm":
            continue
        a = card[k] if isinstance(card[k], list) else [card[k]]
        b = cpu[k] if isinstance(cpu[k], list) else [cpu[k]]
        if not all(math.isfinite(x) for x in a) or len(a) != len(b):
            raise AssertionError(f"{what}: {k} = {card[k]} is not finite or has another shape")
        err[k] = max(abs(x - y) for x, y in zip(a, b))
        tol = FLOAT_SUM_RTOL * max(1.0, max(abs(y) for y in b)) if k in FLOAT_SUM_VALUES else AP_ATOL
        if err[k] > tol:
            raise AssertionError(f"{what}: {k} = {card[k]} against {cpu[k]} on the CPU (tolerance {tol})")
    return err


def blocking_reads(fn, calls):
    """Blocking device-to-host reads over ``calls`` calls of ``fn`` (sync
    debug mode warns at each one)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(calls):
                fn(i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught if "called a synchronizing CUDA operation" in str(w.message)]


def profile_updates(coll, preds, target, batch):
    """Where an update of ``coll`` spends its time: a ``torch.profiler``
    window over PROFILE_BATCHES updates after three of warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def rows(i):
        return preds[i * batch:(i + 1) * batch], target[i * batch:(i + 1) * batch]

    for i in range(3):
        coll.update(*rows(i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3, 3 + PROFILE_BATCHES):
            coll.update(*rows(i))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return profile_summary(prof, wall_s, PROFILE_BATCHES)


def phase_full_classification(preds, target, cpu_bap):
    """The epoch through every classification metric on the card and on the
    CPU; K1 and K2 once per batch; a guarded ConfusionMatrix update reads
    nothing back. BAP's values are held against ``cpu_bap``, the main
    path's CPU run of the same BAP on the same epoch, so the CPU reference
    here leaves BAP out."""
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import histogram as k2

    dev = preds.device
    n_batches = -(-ROWS // BATCH)
    q = make_second_model(dev)
    coll = build_full_classification(mtt, dev)
    kl = mtt.KLDivergence(device=dev)
    torch.cuda.synchronize()
    k1.reset_launch_count()
    k2.reset_launch_count()
    t0 = time.perf_counter()
    update_s = run_full_classification(coll, kl, preds, target, q, torch.cuda.synchronize)
    loop_s = time.perf_counter() - t0
    launches = {"binned_counters": k1.launch_count, "histogram": k2.launch_count}
    t1 = time.perf_counter()
    card = _full_values({**coll.compute(), "kl": kl.compute()})
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t1
    if launches != {"binned_counters": n_batches, "histogram": n_batches}:
        raise AssertionError(f"full classification path: launches {launches} over {n_batches} batches, predicted one of each per batch")
    members = dict(coll.items(keep_base=True, copy_state=False))
    if members["cm"].update_count != n_batches or [sorted(g) for g in coll.compute_groups.values()] != [sorted(g) for g in FULL_GROUPS]:
        raise AssertionError(f"full classification path: groups {coll.compute_groups}")

    # what comes out is right: every row counted once, the diagonal is top-1
    cm = card["cm"]
    top1 = int((preds.argmax(dim=1) == target).sum())
    if cm.shape != (CLASSES, CLASSES) or int(cm.sum()) != ROWS or int(cm.diagonal().sum()) != top1:
        raise AssertionError(f"full classification path: confusion matrix sums to {int(cm.sum())}, diagonal {int(cm.diagonal().sum())}, top-1 rows {top1}")
    if abs(card["hamming"] - 2 * (ROWS - top1) / (ROWS * CLASSES)) > AP_ATOL:
        raise AssertionError(f"full classification path: hamming {card['hamming']} against {2 * (ROWS - top1) / (ROWS * CLASSES)}")

    # the same run of the port on the CPU (K2 is its plain version there),
    # BAP's from the main path
    t2 = time.perf_counter()
    cpu_coll = build_full_classification(mtt, "cpu", bap=False)
    cpu_kl = mtt.KLDivergence(device="cpu")
    run_full_classification(cpu_coll, cpu_kl, preds.cpu(), target.cpu(), q.cpu(), lambda: None)
    cpu = _full_values({**cpu_coll.compute(), "kl": cpu_kl.compute(), "bap": cpu_bap})
    cpu_s = time.perf_counter() - t2
    err = compare_full_values(card, cpu, "full classification path")
    ce_card, ce_cpu = members["ce"].metric_state, dict(cpu_coll.items(keep_base=True, copy_state=False))["ce"].metric_state
    if not torch.equal(ce_card["bin_count"].cpu(), ce_cpu["bin_count"]):
        raise AssertionError("full classification path: calibration bin counts differ from the CPU run")
    bin_rel = {k: float(((ce_card[k].cpu() - ce_cpu[k]).abs() / ce_cpu[k].abs().clamp(min=1e-30)).max()) for k in ("bin_conf", "bin_acc")}
    if max(bin_rel.values()) > FLOAT_SUM_RTOL:
        raise AssertionError(f"full classification path: calibration bin sums off by {bin_rel} (rtol {FLOAT_SUM_RTOL})")
    del q

    # a guarded ConfusionMatrix update: no blocking read on the card (K2
    # counts without reading the ids' range back)
    guarded = mtt.ConfusionMatrix(CLASSES, on_invalid="warn", device=dev)
    plain_cm = mtt.ConfusionMatrix(CLASSES, device=dev)
    for i in range(2):  # warm-up
        guarded.update(preds[i * BATCH:(i + 1) * BATCH], target[i * BATCH:(i + 1) * BATCH])
    torch.cuda.synchronize()
    reads = blocking_reads(lambda i: guarded.update(preds[i * BATCH:(i + 1) * BATCH], target[i * BATCH:(i + 1) * BATCH]), GUARDED_UPDATES)
    plain_reads = blocking_reads(lambda i: plain_cm.update(preds[i * BATCH:(i + 1) * BATCH], target[i * BATCH:(i + 1) * BATCH]), GUARDED_UPDATES)
    if reads:
        raise AssertionError(f"a guarded ConfusionMatrix update read back {len(reads) / GUARDED_UPDATES} times per update: {reads[:3]}")

    profiled = profile_updates(build_full_classification(mtt, dev), preds, target, BATCH)

    emit({
        "phase": "full_classification_path",
        "config": {"rows": ROWS, "classes": CLASSES, "batch": BATCH, "thresholds": THRESHOLDS, "ce_bins": CE_BINS, "seed": SEED,
                   "members": sorted(members), "compute_groups": FULL_GROUPS, "kl": "KLDivergence(first model || second model), outside the collection"},
        "batches": n_batches,
        "rows_per_s": ROWS / loop_s,
        "epoch_s": loop_s,
        "first_update_ms": update_s[0] * 1e3,
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "compute_s": compute_s,
        "launches": launches,
        "values": {k: (v if not isinstance(v, list) else sum(v) / len(v)) for k, v in card.items() if k != "cm"},
        "cm_trace": int(cm.diagonal().sum()),
        "max_abs_err_vs_cpu": err,
        "ce_bin_sum_max_rel_err_vs_cpu": bin_rel,
        "guarded_confmat_blocking_reads_per_update": len(reads) / GUARDED_UPDATES,
        "unguarded_confmat_blocking_reads_per_update": len(plain_reads) / GUARDED_UPDATES,
        "unguarded_blocking_reads_seen": plain_reads[:3],
        "profile": profiled,
        "cpu_reference_s": cpu_s,
        "matches_cpu_run": True,
    })
    return launches, cpu


def make_multilabel_data(device):
    """A COCO-2014-val-shaped multilabel evaluation: 40,504 images, 80
    labels, about 2.9 labels an image; the scores are sigmoids of unit
    normal logits centred at ML_POS_LOGIT for a true label and ML_NEG_LOGIT
    for a false one."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 31)
    target = (torch.rand((ML_ROWS, ML_LABELS), generator=g, device=device) < ML_LABELS_PER_ROW / ML_LABELS).to(torch.int64)
    centre = torch.where(target.bool(), ML_POS_LOGIT, ML_NEG_LOGIT)
    logits = torch.randn((ML_ROWS, ML_LABELS), generator=g, device=device) + centre
    return torch.sigmoid(logits), target


def build_multilabel(pkg, device):
    return pkg.MetricCollection({
        "coverage": pkg.CoverageError(device=device),
        "lrap": pkg.LabelRankingAveragePrecision(device=device),
        "lrl": pkg.LabelRankingLoss(device=device),
        "hamming": pkg.HammingDistance(device=device),
        "cm": pkg.ConfusionMatrix(ML_LABELS, multilabel=True, device=device),
    })


def run_multilabel(coll, preds, target, sync):
    update_s = []
    for start in range(0, preds.shape[0], ML_BATCH):
        t0 = time.perf_counter()
        coll.update(preds[start:start + ML_BATCH], target[start:start + ML_BATCH])
        sync()
        update_s.append(time.perf_counter() - t0)
    return update_s


def phase_multilabel(device):
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import histogram as k2

    preds, target = make_multilabel_data(device)
    n_batches = -(-ML_ROWS // ML_BATCH)
    coll = build_multilabel(mtt, device)
    torch.cuda.synchronize()
    k2.reset_launch_count()
    t0 = time.perf_counter()
    update_s = run_multilabel(coll, preds, target, torch.cuda.synchronize)
    loop_s = time.perf_counter() - t0
    launches = k2.launch_count
    result = coll.compute()
    cm = result["cm"].cpu()
    profiled = profile_updates(build_multilabel(mtt, device), preds, target, ML_BATCH)
    card = {k: float(v) for k, v in result.items() if k != "cm"}
    if launches != n_batches:
        raise AssertionError(f"multilabel path: K2 launched {launches} times over {n_batches} batches")
    # every (image, label) pair counted once in its label's 2 x 2 matrix
    if cm.shape != (ML_LABELS, 2, 2) or not bool((cm.sum(dim=(1, 2)) == ML_ROWS).all()):
        raise AssertionError("multilabel path: a label's confusion matrix does not count every image once")
    if not (1.0 <= card["coverage"] <= ML_LABELS and 0.0 <= card["lrap"] <= 1.0 and 0.0 <= card["lrl"] <= 1.0):
        raise AssertionError(f"multilabel path: implausible values {card}")

    t1 = time.perf_counter()
    cpu_coll = build_multilabel(mtt, "cpu")
    run_multilabel(cpu_coll, preds.cpu(), target.cpu(), lambda: None)
    cpu_result = cpu_coll.compute()
    cpu_s = time.perf_counter() - t1
    if not torch.equal(cm, cpu_result["cm"]):
        raise AssertionError("multilabel path: the confusion matrices differ from the CPU run")
    err = {k: abs(card[k] - float(cpu_result[k])) for k in card}
    # means over the images' float32 values, summed in another order on the card
    tol = {k: FLOAT_SUM_RTOL * max(1.0, abs(float(cpu_result[k]))) for k in card}
    if card["hamming"] != float(cpu_result["hamming"]) or any(err[k] > tol[k] for k in card):
        raise AssertionError(f"multilabel path: card against CPU {err}, tolerances {tol}")
    emit({
        "phase": "multilabel_path",
        "config": {"rows": ML_ROWS, "labels": ML_LABELS, "batch": ML_BATCH, "labels_per_row": ML_LABELS_PER_ROW, "seed": SEED + 31,
                   "shape_of": "COCO 2014 val (40,504 images, 80 categories)"},
        "batches": n_batches,
        "rows_per_s": ML_ROWS / loop_s,
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "k2_launches": launches,
        "profile": profiled,
        "values": card,
        "max_abs_err_vs_cpu": err,
        "cpu_reference_s": cpu_s,
        "matches_cpu_run": True,
    })
    return launches


def full_classification_rank(rank, world, port, results, device):
    """One rank of the four-rank full classification check: its quarter of the epoch."""
    try:
        import torch
        import torch.distributed as dist

        dev, sync = _rank_device(device)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.ops import binned_counters as k1
        from metrics_tpu_torch.ops import histogram as k2

        preds, target = make_data(dev)
        shard = -(-ROWS // world)
        p, y = preds[rank * shard:(rank + 1) * shard].clone(), target[rank * shard:(rank + 1) * shard].clone()
        del preds, target
        coll = build_full_classification(mtt, dev)
        sync()
        dist.barrier()
        k1.reset_launch_count()
        k2.reset_launch_count()
        with CollectiveRecorder() as during_updates:
            update_s = run_full_classification(coll, None, p, y, None, sync)
        launches = {"binned_counters": k1.launch_count, "histogram": k2.launch_count}
        dist.barrier()
        t0 = time.perf_counter()
        with CollectiveRecorder() as rec:
            values = coll.compute()
            sync()
        compute_s = time.perf_counter() - t0
        out = {
            "rank": rank,
            "rows": int(p.shape[0]),
            "batches": len(update_s),
            "update_p50_ms": statistics.median(update_s) * 1e3,
            "compute_s": compute_s,
            "collectives_in_updates": during_updates.all_reduce + during_updates.other,
            "all_reduce": rec.all_reduce,
            "all_reduce_lanes": rec.sizes,
            "other_collectives": rec.other,
            "bytes_sent": rec.bytes,
            "launches": launches,
            "values": {k: (v.numpy() if k == "cm" else v) for k, v in _full_values(values).items()},
            "jax_loaded": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu")),
        }
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def phase_full_classification_dist(cpu_values):
    """The full classification collection over four ranks on the shards of
    the epoch: one all_reduce per bucket, no gather, the values of one
    process on the CPU (``cpu_values``, from phase_full_classification)."""
    import torch

    t0 = time.perf_counter()
    ranks = run_world(full_classification_rank, "full classification over four ranks")
    world_s = time.perf_counter() - t0
    want = {k: v for k, v in cpu_values.items() if k != "kl"}
    errs = []
    for r in ranks:
        if r["jax_loaded"]:
            raise AssertionError(f"rank {r['rank']} loaded {r['jax_loaded']}")
        if r["collectives_in_updates"]:
            raise AssertionError(f"rank {r['rank']}: updates made collectives {r['collectives_in_updates']}")
        if sorted(r["all_reduce"]) != FULL_EVAL_BUCKETS or r["other_collectives"]:
            raise AssertionError(f"rank {r['rank']}: compute() made all_reduce {r['all_reduce']} and {r['other_collectives']}; predicted {FULL_EVAL_BUCKETS}")
        if r["launches"] != {"binned_counters": r["batches"], "histogram": r["batches"]}:
            raise AssertionError(f"rank {r['rank']}: launches {r['launches']} over {r['batches']} batches")
        card = dict(r["values"], cm=torch.from_numpy(r["values"]["cm"]))
        errs.append(compare_full_values(card, want, f"rank {r['rank']} of the four-rank world"))
    emit({
        "phase": "full_classification_dist",
        "config": {"world": DIST_WORLD, "rows_per_rank": [r["rows"] for r in ranks], "batch": BATCH,
                   "backend": "gloo, four processes on one card (loopback TCP; not NCCL)"},
        "world_s": world_s,
        "compute_s": [r["compute_s"] for r in ranks],
        "update_p50_ms": [r["update_p50_ms"] for r in ranks],
        "buckets": FULL_EVAL_BUCKETS,
        "all_reduce_calls": ranks[0]["all_reduce"],
        "all_reduce_lanes": ranks[0]["all_reduce_lanes"],
        "other_collectives_per_compute": [len(r["other_collectives"]) for r in ranks],
        "bytes_sent_per_rank": [r["bytes_sent"] for r in ranks],
        "launches_per_rank": [r["launches"] for r in ranks],
        "max_abs_err_vs_cpu": errs[0],
        "matches_cpu_run": True,
    })
    return sum(r["launches"]["binned_counters"] for r in ranks), sum(r["launches"]["histogram"] for r in ranks)


def k2_confmat_times(preds, target, launches):
    """K2 at the full classification path's shape (1024 ids over 10^6 bins,
    the confusion matrix of 1000 classes, through the global-atomic path),
    beside torch.bincount at the same shape, and its launches there x
    (device time - bound).

    The kernel only adds into counts its caller has zeroed, so two pairs are
    reported, each time beside the bound of the same work: the wrapper's
    whole device work (the 4 MB zeroing and the launch, as the path runs
    them) against the counts written once and the ids read once; and the
    kernel alone against the ids read once and one read and one write of
    each count that this batch touches. Events time the wrapper beside
    torch.bincount's call; the profiler times the card's work of both."""
    import torch

    from metrics_tpu_torch.ops import histogram as k2

    dev = preds.device
    ids = (target[:BATCH] * CLASSES + preds[:BATCH].argmax(dim=1)).to(torch.int32).contiguous()
    n, nb = int(ids.shape[0]), CLASSES * CLASSES
    touched = int(torch.unique(ids).numel())
    lib = k2._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.zeros(nb, dtype=torch.int32, device=dev)

    def raw():
        out.zero_()
        err = lib.histogram_launch(ids.data_ptr(), n, nb, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"histogram launch failed with cudaError {err}")

    raw()
    if not torch.equal(out, k2.histogram_plain(ids, nb)):
        raise AssertionError("K2 disagrees with its plain version at the confusion matrix's shape")
    fns = {
        "wrapper": lambda: k2.histogram(ids, nb),
        "plain": lambda: k2.histogram_plain(ids, nb),
        "library": lambda: torch.bincount(ids, minlength=nb),
    }
    times = {}
    for label in ["plain", "wrapper", "library", "library", "wrapper", "plain"]:
        times.setdefault(label, []).append(cuda_time_ms(fns[label]))
    ms = {label: statistics.mean(v) for label, v in times.items()}
    ops_ms = n / FP32_OPS_PER_S * 1e3  # one atomic add per id

    def bound(bytes_moved):
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    bound_ms, bound_by = bound(4 * n + 4 * nb)  # int32 ids in, every int32 count written
    kernel_bound_ms, kernel_bound_by = bound(4 * n + 8 * touched)  # ids in, touched counts read and written
    kernel_device = device_ms_per_launch(raw, "histogram_kernel")
    wrapper = device_profile(fns["wrapper"], "histogram_kernel")
    wrapper_device = wrapper["all_device_ms_per_call"]
    return {
        "shape": {"n": n, "bins": nb, "touched_bins": touched},
        # the path's work per batch: zeroing and launch, on the card
        "wrapper_device_ms": wrapper_device,
        "wrapper_device_ops_per_call": wrapper["device_ops_per_call"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "launches": launches,
        "launches_x_gap_ms": launches * (wrapper_device - bound_ms),
        # the kernel alone, into zeroed counts
        "kernel_device_ms": kernel_device,
        "kernel_bound_ms": kernel_bound_ms,
        "kernel_bound_by": kernel_bound_by,
        # by events, each a whole call
        "ms": ms["wrapper"],
        "plain_ms": ms["plain"],
        "library_ms": ms["library"],
        "library_call": f"torch.bincount(ids, minlength={nb})",
        "library_device_ms": device_profile(fns["library"], "")["all_device_ms_per_call"],
    }


def k2_path_launches(entry, launches):
    """K2's launches on the dist path into its kernels entry, and their
    launches x (device time - bound): each rank calls
    sharded_descending_ranks once on each kind of score, on its own ids
    (the all-equal scores put every id in one bin)."""
    kinds = {"quantized": "path_ids", "continuous": "path_continuous", "equal": "all_equal"}
    per_kind = launches // len(kinds)
    if per_kind * len(kinds) != launches:
        raise AssertionError(f"{launches} K2 launches on the dist path are not {len(kinds)} kinds x its ranks")
    per_input, bound_ms = entry["by_input"], entry["bound_ms"]
    gap = {kind: per_kind * (per_input[x]["kernel_device"] - bound_ms) for kind, x in kinds.items()}
    prev_gap = {kind: per_kind * (per_input[x]["prev_kernel_device"] - bound_ms) for kind, x in kinds.items()}
    entry["launches"] = launches
    entry["dist_path"] = {
        "launches_per_kind": per_kind, "ids_per_kind": kinds,
        "launches_x_gap_ms": sum(gap.values()), "by_kind_ms": gap,
        "previous_design_launches_x_gap_ms": sum(prev_gap.values()), "previous_design_by_kind_ms": prev_gap,
    }


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this script measures the port on a GPU and has no CPU mode")
    if not (ROOT / "metrics_tpu_torch" / "__init__.py").is_file() or not (ROOT / "metrics_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (metrics_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({
        "phase": "device",
        "kind": kind,
        "count": count,
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    })
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    device = torch.device("cuda", 0)
    preds, target = make_data(device)
    k1_err = phase_parity(preds, target)
    k2_err = phase_k2_parity(device)
    k3_fold_err = phase_k3_parity(device)
    k3_err = phase_k3_cascade_parity(device)
    k1_launches, cpu_bap = phase_main_path(preds, target)
    phase_windowed(preds, target)
    full_launches, full_cpu_values = phase_full_classification(preds, target, cpu_bap)
    k2_multilabel_launches = phase_multilabel(device)
    stream = make_stream(device)
    k3_launches, q_state = phase_stream(stream)
    phase_profile(preds, target)
    phase_stream_profile(stream)
    first_batch = stream[:STREAM_BATCH].clone()
    del stream
    # the kernels' times, before any path spawns its ranks
    kernels = [
        k1_times(preds, target, k1_launches, k1_err),
        k2_times(device, k2_err),
        k3_times(device, k3_launches, k3_err, k3_fold_err, q_state, first_batch),
    ]
    kernels[1]["confmat_shape"] = k2_confmat_times(preds, target, full_launches["histogram"])
    del preds, target, q_state, first_batch
    torch.cuda.empty_cache()
    k2_launches = phase_dist(device)
    k2_path_launches(kernels[1], k2_launches)
    k1_fused_launches, fused_values = phase_fused_eval(device)
    k3_fused_launches = phase_fused_sketch(device)
    k1_overlapped_launches, k3_quantized_launches = phase_sync_layer(device, fused_values)
    k1_full_dist_launches, k2_full_dist_launches = phase_full_classification_dist(full_cpu_values)
    # each kernel's launches on every path that runs it, each path counted
    # from zero just before it
    kernels[0]["launches_by_path"] = {
        "main_path": k1_launches, "fused_dist_path": k1_fused_launches, "overlapped_path": k1_overlapped_launches,
        "full_classification_path": full_launches["binned_counters"], "full_classification_dist": k1_full_dist_launches,
    }
    kernels[1]["launches_by_path"] = {
        "dist_path": k2_launches, "full_classification_path": full_launches["histogram"],
        "multilabel_path": k2_multilabel_launches, "full_classification_dist": k2_full_dist_launches,
    }
    kernels[2]["launches_by_path"] = {"stream_path": k3_launches, "fused_sketch_path": k3_fused_launches, "quantized_sketch_path": k3_quantized_launches}
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})


if __name__ == "__main__":
    main()
