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
   values of k whose buffers run out of device memory, and at the sketch
   shapes of the drift monitors and the telemetry histograms (33, 34));
4. main path: an ImageNet-1k validation epoch (50,000 rows, 1000 classes,
   1024-row batches) through ``MetricCollection({acc1, acc5, bap})`` on the
   card, checked against the same run of the port on the CPU;
5. stream path: an online score monitor, 64 batches of 2^20 lognormal rows
   (0.1 % NaN/±inf) through ``MetricCollection({q: QuantileSketch, distinct:
   HyperLogLog, freq: CountMinSketch})`` at their default sizes, checked
   against exact answers on the card, and its first 17 batches (two
   forwards among them) against the same run on the CPU;
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
   the port in one process on the CPU (``{auroc, ap}``, the list mode: the
   card's rings are held against the same values) and against an exact
   float64 Mann-Whitney AUROC computed on the card;
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
   are those of the one-process CPU run;
15. pure path (before the kernels line): the fused evaluation epoch through
   ``functionalize(MetricCollection({acc, prec, rec, f1, bap, per_class:
   ClasswiseWrapper(Recall(average=None))}))`` (BAP under ``"warn"``: the
   pure layer refuses ``"drop"`` on it): after every batch the pure state
   bit-equal to the stateful collection's and the input state unchanged,
   ``compute`` equal to the stateful ``compute()``, two half-epoch states
   merged equal to the epoch's, the fault counts those injected, K1 once
   per pure update, no blocking read in a guarded pure update;
16. bootstrap path: ``bootstrap_functionalize(Accuracy(num_classes=1000),
   100)`` over the epoch with a generator on the card: the vmapped update
   bit-equal to one ``functionalize`` update per replica on the same
   indices, the mean within 3 std of top-1, the std within 2x of
   sqrt(p(1-p)/N);
17. regression path: a MovieLens-20M held-out split (2,000,026 seeded
   half-star ratings, 8192-row batches) through thirteen regression
   metrics and wrappers for three epochs under ``MetricTracker``, against
   the CPU run (counts and Spearman's ranks exact) and float64; a
   QM9-shaped 13,083 x 12 check of ``MultioutputWrapper`` and
   ``CosineSimilarity``;
18. pairwise path: the four ``pairwise_*`` functions on 4096 x 768 float32
   embeddings, against themselves and against 1024 rows, held against
   float64 on the CPU, with their peak memory;
19. in the world of phase 8: the pure collection over the group (one
   ``all_reduce`` per bucket of the fused members, then the wrapper's own,
   no gather), its overlapped cycle (one fused sync) and read (no
   collective, bit-equal to the fresh read), the bootstrap of phase 16 over
   the group, guarded (the 100 replicas' stacked state in one ``all_reduce``
   per bucket, no gather; the mean within 3 std of the stateful accuracy of
   the clean rows, the std within 2x of the binomial one), and a quarter of the
   MovieLens rows per rank through ``{PearsonCorrCoef, SpearmanCorrCoef,
   R2Score, MeanSquaredError}`` (Pearson's moments stacked, Spearman's
   rings gathered), equal to one process;
20. retrieval path: an MS MARCO passage-ranking dev evaluation (6,980
   queries, 6,668,967 BM25 top-1000 candidate rows, about 1.07 relevant
   passages a query, 14 % of the queries without a relevant candidate;
   seeded N(0, 1) scores, N(1.97, 1) for relevant passages) streamed 64 queries
   a batch through ten retrieval metrics (MRR, MAP, nDCG@10, P@10, R@100,
   HitRate@10, FallOut@10, R-precision, the precision/recall curve to 100
   and the recall at precision 0.1), in the list mode and with
   ``capacity=2**23``: each mode against the port's CPU run in the list
   mode (exact per-query values bit-equal; the CPU's capacity-mode run is
   cut for the script's time), the modes against each other, MRR, MAP and
   nDCG@10 against float64 numpy, no read back in a capacity update;
21. sliced path: the fused evaluation epoch split into 256 cohorts,
   ``{acc, prec, rec, f1}`` each a ``SlicedMetric(..., pad_batches=True)``
   of a guarded (``"drop"``) metric beside an unsliced BAP: the rings equal
   to the CPU run, eight slices equal to demuxed instances, the rollup
   equal to the unsliced metrics on the in-range rows, the quarantined,
   discarded and padded rows and the faults as injected, K1 once per
   batch, the BAP against the fused evaluation's CPU run of the same epoch
   (within ``AP_ATOL``), a sliced Binned metric and a sliced confusion
   matrix refused on the card where K1 and K2 would launch, and the update
   at K = 256 beside K = 1;
22. in the world of phase 8: the MS MARCO rows in 4096-row chunks dealt
   round-robin through MRR, MAP and nDCG@10 in both modes (the gathers
   counted, equal to one process over the union), the sliced collection's
   overlapped cycle (no more ``all_reduce`` than the unsliced one, no
   gather) and ``sliced_functionalize(Accuracy, 256,
   shard_slices=WORLD)`` (each rank's 64 slices equal to one process, one
   ``all_reduce`` and six ``reduce_scatter``);
23. compiled path (after the kernels line): the ImageNet epoch through the
   main path's collection, guarded and padded (``{acc1, acc5}`` with
   ``on_invalid="drop"``, BAP with ``"warn"``: it takes no row mask), once
   with its updates captured into CUDA graphs and once eager
   (``jittable_update = False``), in turns: the states bit-equal after every
   batch and again after a ``reset``, a ``load_state_dict`` and a
   ``sync``/``unsync`` (each followed by updates), every member replaying,
   K1's launches counted through the replays equal to BAP's updates, the
   card's records of K1 inside a profiled window of replays; update p50,
   operations, blocking reads and the idle share of both, the graph pools'
   bytes; one update of K2 (a guarded ``ConfusionMatrix(1000)``) and of K3
   (``QuantileSketch(eps=0.01)`` over 2^20 rows) captured and held bit-equal
   to its eager twin over replays. The retrieval path (20) also runs its
   capacity mode padded up the ladder, captured and eager, bit-equal;
24. serving path: the same collection behind ``ServeLoop(workers=4,
   warmup=Warmup(<one 1024-row batch>))`` on the ladder ``(64, 256, 1024)``,
   the epoch's 50,000 rows offered as ragged requests (a tier drawn
   uniformly, then a size within it): ``accepted + shed == offered``, the
   merged states bit-equal to one eager collection over the accepted
   requests, K1 once per BAP update, no capture on the request path after
   ``wait_warmup()``; per-request update p50/p99 by tier, ``report()``
   stale and fresh;
25. cold start: the first request at each tier on fresh loops, with and
   without warmup, p50/p99 over five loops each, and the warmup's wall time;
26. image functional path (after the multi-process phases): every
   functional image metric on one seeded batch on the card against the
   port's CPU run (PSNR, SSIM, MS-SSIM, UQI and the gradients at
   16x3x256x256, ERGAS, SAM and D-lambda at 16x8x128x128), and SSIM p50 at
   2x3x512x512 (``bench.py``'s shape) in both forms of the separable window;
27. FID-50K: the protocol of class-conditional ImageNet 256x256 generation
   (DiT), cut to FID-10K for the script's time: 10,000 seeded "real" and
   10,000 "generated" 3x256x256 uint8 images made on the card a batch at a
   time, through one
   ``InceptionV3Extractor`` (fid variant, seeded weights, resize 256 ->
   299) in batches of 250, each forward giving the 2048 features and the
   1008 logits; ``FrechetInceptionDistance`` and ``KernelInceptionDistance``
   (100 subsets of 1000) in the list mode, ``InceptionScore`` (10 splits)
   on the generated logits, and ``FrechetInceptionDistance(capacity=65536)``
   whose update must be captured (one graph a side) and replayed on every
   later batch. FID within ``1e-3`` of a float64 FID whose ``sqrtm`` scipy
   takes on the host, the capacity mode within ``1e-3`` of the list mode,
   the real set against itself within ``1e-4`` of the traces that cancel in
   it in float32 (the card's float32 products give it a floor of about
   3e-5 of them: ``tools/fid_float32_floor.py``) and within ``1e-3`` in
   float64, KID (float64 on the
   card) and IS (float64 numpy) on the same subsets and permutation, the
   first 32 features and logits of each set against the port's CPU run; images/s in float32
   and, on eight batches, in TF32, the extractor's peak memory (and what
   earlier phases still held when its loop began), each
   compute's seconds and the ladder's rung;
28. LPIPS and SSIM path: 50,000 pairs made the same way through
   ``LearnedPerceptualImagePatchSimilarity(net_type="alex")``, streaming
   SSIM and MS-SSIM and PSNR (each update captured but LPIPS's), each held
   against the port's CPU run on the first 64 pairs and the streamed SSIM
   against the accumulate mode over the first 1024; pairs/s and update
   p50 of each. The image phases launch none of K1-K3 (their counts read 0);
29. text summarization path: a CNN/DailyMail-test-sized evaluation (11,490
   seeded (candidate, reference) summaries of 3-4 newline-joined sentences,
   about 56 tokens a reference, from a 50,000-word Zipf lexicon) through
   ``ROUGEScore`` (rouge1, rouge2, rougeL, rougeLsum) and ``BERTScore`` over
   a seeded BERT-base (``BertEncoder``, layer 9, 128 tokens, a hash
   WordPiece stand-in tokenizer) in 256-pair batches, then a
   ``BERTScore(idf=True)`` loaded with its state: ROUGE over the first
   1,024 pairs equal to the CPU run and over all within 1e-6 of float64
   means of the same per-pair values; BERTScore on the first 32 pairs
   against BERT-base on the CPU, the matching against float64 from the
   card's own embeddings, candidates equal to their references at F1 = 1,
   the own reference above a shuffled one; pairs/s, update p50, compute
   seconds with and without IDF, peak memory, ROUGE's host seconds;
30. text metrics path: every other text class on the card against the
   CPU run: LibriSpeech-test-clean-sized ASR (2,620 utterances, about 5 %
   WER) through WER, CER, MER, WIL and WIP (counts equal to the CPU run
   over the first 1,024 and to a plain Levenshtein on the host over all),
   WMT14-newstest2014-sized MT (3,003 segments, the first 1,024 on the CPU)
   through BLEU, SacreBLEU (13a), chrF++, EED and TER (the first 1,000
   segments; 200 of them on the CPU), SQuAD-v1.1-dev-sized
   QA (10,570 questions); update p50 of each class and the launches a
   batch of the edit-distance wavefront and of EED's loop. Neither text
   phase launches K1-K3;
31. backend probe: ``ensure_backend()``, started on a thread before this
   process initialises CUDA (so its probe, a fresh interpreter that
   initialises CUDA, runs while the kernels build and the parity phases
   run), returns ``"cuda"``; its seconds and ``health_report()["backend"]``;
32. snapshot path, in three parts: each rank of the fused evaluation (8)
   saves its local state as rank r of 4 before its ``compute()``, and the
   parent restores the group at world 1 on the card, whose values equal the
   synced ones (counts and fault counts exactly, BAP within ``AP_ATOL``);
   a corrupt newest file of that collection falls back to the previous
   step (one ``snapshot_fallback`` event, a stale ``.tmp`` ignored); each
   rank of the fused sketch path (11) saves too, and the world-1 restore
   merges the four sketches with K3 (three launches), bit-equal to the
   in-process fold; after the MS MARCO capacity-mode run (20) its MRR, MAP
   and nDCG@10 save (the rings of 6,668,967 rows), restore into fresh
   metrics, and compute per-query values bit-equal; bytes and seconds,
   split into read-back, digest, pickle and write;
33. drift path (on the stream of phase 5): ``DriftMonitor("score",
   window=2**22, eps=0.01)`` with its reference frozen after batches 0-3,
   batches 32-63 the rollout (rows times ``exp(0.5)``), and
   ``DriftMonitor("item_id", window=2**22)`` over Zipf(1.1) item ids of
   10^6, 2^20 a batch, whose hot set is permuted at batch 32; a check after
   every batch: no breach before batch 32, each monitor's first breach by
   batch 36, one ``drift_detected`` event and one flight record per
   monitor, the dropped rows equal to the stream's non-finite rows, KS
   within ``score_floor()["ks"]`` of a float64 KS over the same window's
   finite rows before and after the shift, no blocking read in
   ``observe``, K3's launches equal to the fold chunks; ``observe`` p50,
   ``check`` p50 and rows/s;
34. serving observability path: the served epoch of phase 24 again, with
   ``snapshot_every_s=0.5``, a ``DriftMonitor`` over the top-1 confidence,
   tracing forced on and a flight recorder installed: ``scrape()`` counts
   the requests served, the ``serve_update_ms`` quantiles lie within the
   histogram's eps rank of the spans' own durations, a fresh loop restored
   from ``save_snapshot()`` reports values bit-equal to the served loop's,
   no capture on the request path, one ``serve.update`` span per request
   in the exported Chrome trace, K1 once per BAP update and K3 once per
   fold; the request p50/p99 beside phase 24's.

35. fleet path (after 34): the served epoch of phase 24 dealt round-robin to
   four hosts, each a ``ServeLoop`` (one worker) over ``{acc1, acc5, bap, q:
   QuantileSketch}`` (``q`` of each request's top-1 confidence) publishing
   delta views through a ``FleetPublisher`` over HTTP on 127.0.0.1 to one of
   two pod ``Aggregator``s, each publishing to one global aggregator, every
   aggregator behind its own ``FleetServer``: the global view bit-equal to
   one eager collection over the epoch (counts and BAP's counters), its
   sketch bit-equal to an in-process ``sketch_merge`` fold of the hosts'
   sketches in the aggregators' order and within eps of the exact
   quantiles, a re-delivered blob answered ``duplicate``, a flipped byte
   refused (HTTP 400) naming the host and the leaf, a stopped host named
   stale in the global scrape within ``stale_after_s`` plus one cadence with
   one ``fleet_host_stale`` event, an int8 pass (counts exact, BAP's
   counters within the codec's bound), K1 once per BAP update and K3 once
   per sketch insert and merge (the hosts' updates and reduces, the
   aggregators' folds, the telemetry folds); bytes a view, publish p50, the
   global fold, the last request to the global report, blocking reads a
   publish;
36. detection path: a COCO val2017-shaped bbox evaluation (5,000
   seeded images of 640x480 and 480x640, 36,781 ground truths over 80
   classes with COCO's small/medium/large shares, 100 detections an image)
   through ``MeanAveragePrecision(class_metrics=True)`` 16 images an
   update, and a segm run on 128 of the images (masks made on the card):
   every output equal to the port on the CPU over the first 500 (bbox) and
   16 (segm) images, the matches of the first 32 images' cells equal to a
   per-cell greedy loop in pycocotools' order, and F12 on the card: the
   fused evaluation world's four ranks, each over a quarter of the first
   500 images, compute the one-process values with twelve gathers; K1-K3
   launch 0 times; update p50, images/s, ``compute()`` split into cells,
   matching and accumulation, the matcher's launches, peak memory.

37. audio path (after 36): a WSJ0-2mix test-split-shaped separation
   evaluation, 3,000 seeded two-speaker mixtures at 8 kHz (1.5-10 s, 5 h,
   rounded to 0.5 s so a batch holds one length and no clip is padded;
   speech-shaped voices with pauses mixed at -2.5 to 2.5 dB; estimates at
   planted SI-SDRs of 5-20 dB in a seeded speaker order), made on the card,
   16 mixtures an update through ``PermutationInvariantTraining(SI-SDR)``,
   then ``pit_permutate`` and ``ScaleInvariantSignalDistortionRatio``,
   ``SignalDistortionRatio`` (dense, and 10 CG steps), ``SignalNoiseRatio``,
   ``ScaleInvariantSignalNoiseRatio`` and native
   ``ShortTimeObjectiveIntelligibility`` (plain and extended): PIT's
   permutations equal the planted ones bit for bit, every value of the first
   8 mixtures equals the port's CPU run within ``AUDIO_CPU_ATOL``, SDR and
   SI-SDR within ``AUDIO_F64_ATOL`` of the same formulas in float64 on the
   card, CG within ``AUDIO_CG_DB`` of the dense solve, each ``compute()``
   the float64 mean of the clips' values, the device-only updates captured
   with no blocking read in SI-SDR, SNR and PIT, STOI's capture refused (it
   reads back by design), K1-K3 0 launches; clips/s and update p50 by the
   card's events, kernels a clip, peak memory, STOI's host seconds;
38. lock witness path (last): ``ServeLoop`` of two workers with tracing, a
   drift monitor, snapshots, a flight recorder and a ``FleetPublisher`` to
   an ``Aggregator`` over HTTP on 127.0.0.1, then an overlapped-sync
   collection read across two ranks, in two processes started with
   ``METRICS_TPU_LOCKCHECK=1``: no finding, every observed order edge
   rising in the lock hierarchy (``WITNESS_RANKS``); its order edges and the
   served update p50 armed against the same stream unarmed in this process.

The ``budget`` line sums the seconds that phases 31-34 add (a rank's save:
the slowest of the four), against their 30 s, those of phases 35-36
(the detection ranks' share of the fused world: the slowest of the four)
against theirs, and those of phases 37-38 against their 45 s; every phase
line carries ``t_s``, its seconds since the script started.

Every CUDA metric of the earlier phases captures its update as well (the
port's default on the card); their checks against the CPU runs hold the
captured updates to the plain ones.

The parent process builds every kernel before it spawns the ranks, so the
ranks only load the libraries. A rank that fails makes the script fail.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, the script prints no result and exits 1.
"""
import contextlib
import ctypes
import hashlib
import json
import math
import os
import pathlib
import queue
import shutil
import socket
import statistics
import subprocess
import tempfile
import sys
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

_T0 = time.perf_counter()

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
STREAM_CPU_BATCHES = 17  # the stream's batches held against the CPU run: 0-16, forwards at 0 and 16 (cut from 64)
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
# the pure layer, regression and pairwise
BOOTSTRAPS = 100  # bootstrap_path's replicas
MOVIELENS_RATINGS = 20_000_263  # MovieLens-20M's ratings (GroupLens ml-20m README)
MOVIELENS_ROWS = 2_000_026  # a 10 % held-out split of them
MOVIELENS_BATCH = 8192
# the ratings of ml-20m's ratings.csv per half star, 0.5 to 5.0 (GroupLens
# ml-20m; they sum to the README's 20,000,263, mean 3.5255): the weights of
# the seeded draw
MOVIELENS_RATING_COUNTS = (239_125, 680_732, 279_252, 1_430_997, 883_398, 4_291_193, 2_200_156, 5_561_926, 1_534_824, 2_898_660)
MOVIELENS_NOISE = (1.0, 0.9, 0.8)  # the prediction noise of the three tracked epochs: the last is the best
MOVIELENS_RING = 1 << 21  # the whole split fits
MOVIELENS_WORLD_RING = 1 << 19  # a rank's quarter fits
MOVIELENS_BOOTSTRAPS = 10
REG_F64_ATOL = 1e-4  # RMSE, Pearson and Spearman of 2 * 10^6 float32 rows against float64
REG_F64_RTOL = 1e-5  # QM9's per-target MAE and mean cosine against float64
QM9_ROWS = 13_083  # the 10 % test split of QM9's 130,831 molecules
QM9_TARGETS = 12
QM9_BATCH = 1024
PAIR_N, PAIR_M, PAIR_D = 4096, 1024, 768  # BERT-base-wide embeddings
PAIR_CHECK_ROWS = 256  # rows of each output held against float64 on the CPU
# float32 sums over 768 terms against float64: products (cosine, linear),
# a difference of norms (euclidean), absolute differences (manhattan)
PAIR_ATOL = {"pairwise_cosine_similarity": 1e-5, "pairwise_euclidean_distance": 1e-3,
             "pairwise_linear_similarity": 2e-3, "pairwise_manhattan_distance": 5e-3}
# the retrieval path: MS MARCO passage ranking, dev "small" (6,980 queries;
# BM25's top-1000 candidates, 6,668,967 rows in top1000.dev; 7,437 qrels,
# about 1.07 a query; BM25 recall@1000 about 0.86)
MSMARCO_QUERIES = 6980
MSMARCO_ROWS = 6_668_967
MSMARCO_DEPTH = 1000
MSMARCO_SHORT_QUERIES = 640  # queries with fewer than 1000 candidates, drawn so the counts sum to MSMARCO_ROWS
MSMARCO_RECALL = 0.86  # queries with a relevant candidate
MSMARCO_SECOND_REL = 0.07  # of those, the share with two
MSMARCO_MU = 1.97  # relevant scores N(mu, 1) against N(0, 1): MRR near BM25's 0.18-0.19
MSMARCO_QUERY_BATCH = 64  # whole queries a batch: 110 batches of about 61k rows
MSMARCO_CAPACITY = 1 << 23  # the capacity mode's rings: every row fits
MSMARCO_WORLD_CAPACITY = 1 << 21  # a rank's quarter fits
MSMARCO_WORLD_CHUNK = 4096  # rows dealt round-robin to the ranks
MSMARCO_WORLD_BATCH = 65536
MSMARCO_WORLD_METRICS = ("mrr", "map", "ndcg@10")
# per-query values exact in float32 (sums of 0/1): bit-equal between runs
RETRIEVAL_EXACT = ("mrr", "p@10", "r@100", "hit@10", "fallout@10", "rprec")
# the sliced path: the JAX registry's acceptance K (_SLICED_K)
SLICES = 256
SLICE_SAMPLES = 8  # slices held against demuxed instances
# the compiled update and serving: the JAX bench's serving ladder and its
# ragged request sizes (a tier drawn uniformly, then a size within it)
SERVE_LADDER = (64, 256, 1024)
SERVE_SPANS = {64: (1, 64), 256: (65, 256), 1024: (257, 1024)}
SERVE_WORKERS = 4
W5_BATCHES = 4  # updates after each event that changes the states' identity
CAPTURE_UPDATES = 10  # updates of each kernel's capture check: eager, capture, then replays
SNAPSHOT_DIR_ENV = "CHIP_SMOKE_SNAPSHOT_DIR"  # where the fused paths' ranks save their local states
DRIFT_WINDOW = 1 << 22
DRIFT_EPS = 0.01
DRIFT_REFERENCE_BATCHES = 4  # batches 0-3 bless the reference
DRIFT_SHIFT_AT = 32  # batches 32-63: the rollout, the same rows times exp(DRIFT_SHIFT)
DRIFT_SHIFT = 0.5  # lognormal mu + 0.5: the exact KS is 2 * Phi(0.25) - 1 = 0.197
DRIFT_DETECT_BY = 36  # one window rotation after the shift
ITEM_IDS = 1_000_000
ITEM_ZIPF = 1.1
ITEM_HOT = 64  # the hot ranks whose ids the rollout moves
SERVE_SNAPSHOT_EVERY_S = 0.5
SERVE_DRIFT_WINDOW = 1 << 16
NEW_PHASES_LIMIT_S = 30  # what backend_probe, snapshot_path, drift_path and serving_obs_path may add together
NEW_PHASE_S = {}  # their seconds of command (a rank's save: the slowest of the four, which run at once)
SLICE_PHASES_LIMIT_S = 30  # what fleet_path and detection_path may add together
SLICE_PHASE_S = {}  # their seconds of command (the detection ranks' share: the slowest of the four)
# (levels, k) of the quantile sketches the new paths fold with K3, each held
# against its plain version at its own shapes by phase_k3_cascade_parity
DRIFT_SKETCH_SHAPE = (15, 5600)  # drift_path's score monitor: eps 0.01, window 2^22
ITEM_SKETCH_SHAPE = (17, 1120)  # drift_path's item-id monitor: eps 0.05, window 2^22
TELEMETRY_SKETCH_SHAPE = (10, 4600)  # the LatencyHistograms, and serving_obs_path's monitor (eps 0.01, window 2^16)
COLDSTART_LOOPS = 5  # fresh serving loops timed with and without warmup
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")  # host calls that launch a kernel, as the profiler names them
RECORDED_SHARE = 0.95  # least share of a profiler window's launches whose records on the card it must keep
# the image slice (phases 26-28)
IMG_SIZE = 256  # ImageNet 256x256, the class-conditional generation protocol (DiT)
# FID-50K's 50,000 real and 50,000 generated images, cut to FID-10K: the
# float32 extractor reads 1,162-1,460 images/s on the card, and at 100,000
# images the three image phases took over their 150 s (PERF.md §4)
FID_IMAGES = 10_000
PAIR_IMAGES = 50_000  # the LPIPS and SSIM phase's pairs: FID-50K's count
FID_BATCH = 250
FID_CAPACITY = 65_536  # the capacity mode's rings: every feature row fits
IS_SPLITS = 10  # the 50,000-sample, 10-split protocol of Salimans et al. (2016)
KID_SUBSETS = 100  # KernelInceptionDistance's defaults
KID_SUBSET_SIZE = 1000
FID_CPU_IMAGES = 32  # images of each set held against the port's CPU run (cut from 128 for the phase's time)
TF32_BATCHES = 8  # batches timed through the extractor in TF32 beside float32
PAIR_CPU = 64  # pairs held against the port's CPU run (cut from 128 for the script's time)
PAIR_STREAM_CHECK = 1024  # pairs of the streamed-against-accumulated SSIM check
IMG_FUNCTIONAL_RGB = (16, 3, 256, 256)
IMG_FUNCTIONAL_MS = (16, 8, 128, 128)  # multispectral bands for ERGAS, SAM and D-lambda
SSIM_BENCH_SHAPE = (2, 3, 512, 512)  # bench.py's _phase_ssim
SSIM_BENCH_ITERS = 30
IMG_RTOL = 1e-5  # float32 windows, pools and convolutions summed in another order on the card
IMG_ATOL = 1e-5
FID_RTOL = 1e-3  # against scipy's float64 sqrtm, and the capacity mode against the list mode,
FID_ATOL = 1e-3  # with this atol: the bound of tests/image/test_image.py:229
# FID of the real set against itself in float32, over the two traces
# (2 tr(sigma)) that cancel in it: the card read -1.02e-3 on traces of
# 16.69, 3.1e-5 of them, with float32 products 5.8e-7 off float64 (not
# TF32) and the same ladder in float64 on the same covariances at -4.6e-13;
# on the CPU JAX's float32 ladder read -2.7e-4 and the port's -2.0e-4 there
# (tools/fid_float32_floor.py): the floor is the card's float32 products
FID_SELF_RTOL = 1e-4
FID_SELF_ATOL = 1e-3  # the same in float64 (frechet_inception_distance_from_features, D47)
KID_IS_RTOL = 1e-4  # float32 on the card against float64 numpy on the same subsets and permutation
KID_ATOL = 1e-6  # besides KID_IS_RTOL: a subset's MMD sums 10^6 float32 kernel values of order 1
FEATURE_RTOL = 1e-3  # InceptionV3 features and logits, card against CPU, float32 convolutions on both
FEATURE_ATOL = 5e-4  # 1.25e-3 of the features' mean magnitude (about 0.4): the card read up to 2.1e-4 off (cuDNN's float32 algorithms)
# the text slice (phases 29-30): seeded corpora made on the host
LEXICON = 50_000  # pseudo-words, about 4.8 letters on average
ZIPF_S = 1.1  # word frequencies
COMMA_SHARE = 0.06  # words followed by a comma
CNNDM_PAIRS = 11_490  # the CNN/DailyMail test split (See et al. 2017)
CNNDM_SENTENCES = (3, 4)  # a reference summary's sentences
CNNDM_WORDS = 56  # a reference summary's mean tokens (the split's statistics)
SUMM_BATCH = 256
BERT_LAYER = 9  # bert_score's layer for bert-base-uncased
BERT_MAX_LENGTH = 128
CLS_ID, SEP_ID, PAD_ID = 101, 102, 0
ROUGE_CPU_PAIRS = 1024  # pairs of the ROUGE run held exactly against the port's CPU run
ROUGE_MEAN_RTOL = 1e-6  # the float32 corpus means against float64 means of the same per-pair values
BERT_CPU_PAIRS = 32  # pairs of the BERTScore run held against BERT-base on the CPU
BERT_CPU_ATOL = 1e-5  # P/R/F1, card against CPU: nine float32 layers in another order (1.8e-7 read, PERF.md §6)
BERT_F64_ATOL = 1e-5  # the matching recomputed in float64 from the card's own embeddings
BERT_SELF_ATOL = 1e-6  # candidates equal to their references: F1 = 1
LIBRISPEECH_UTTERANCES = 2_620  # LibriSpeech test-clean
LIBRISPEECH_WORDS = 20
ASR_ERRORS = (0.03, 0.01, 0.01)  # substitutions, deletions, insertions: about 5 % WER
WMT14_SEGMENTS = 3_003  # newstest2014 en-de
WMT14_WORDS = (10, 40)
MT_ERRORS = (0.15, 0.07, 0.07, 0.05)  # substitutions, deletions, insertions, adjacent swaps
SQUAD_QUESTIONS = 10_570  # SQuAD v1.1 dev
TEXT_BATCH = 256
FLEET_HOSTS = 4
FLEET_PODS = 2
FLEET_PUBLISH_EVERY_S = 0.5  # the hosts' and pods' publish cadence
FLEET_REDUCE_EVERY_S = 1.0  # the hosts' reduce cadence: a publish between two reduces reuses the view (D62)
FLEET_STALE_AFTER_S = 1.5  # three cadences: a busy pod's views never age past it
FLEET_STALE_SLACK_S = 1.0  # after stale_after_s, the pod's next publish must carry the verdict
FLEET_EPS = 0.01  # the served QuantileSketch's eps
COCO_SEED = 17
COCO_IMAGES = 5000  # COCO val2017
COCO_GT_BOXES = 36_781  # its annotated instances
COCO_CLASSES = 80
COCO_DETS = 100  # a detector's top 100 an image
COCO_AREA_SHARES = (0.41, 0.34, 0.25)  # small, medium and large objects
COCO_UPDATE_IMAGES = 16  # a detector's evaluation batch
COCO_CPU_IMAGES = 500  # images of the bbox run held against the CPU run, and F12's world
COCO_SEGM_IMAGES = 128  # the segm run: 100 masks of 307,200 pixels are 31 MB an image
COCO_SEGM_CPU_IMAGES = 16
COCO_GREEDY_IMAGES = 32  # images whose cells are held against the per-cell greedy loop
TEXT_CPU_BATCHES = 4  # the CPU runs of the ASR and MT classes: their first 4 batches (1,024 rows), cut for the phase's time
TER_CARD_SEGMENTS = 1000  # TER's host shift search: the first 1,000 segments on the card
TER_CPU_SEGMENTS = 200  # and the first 200 of them in the CPU run
WSJ_SEED = 23
WSJ_MIXTURES = 3000  # WSJ0-2mix's test split (tt): 3,000 two-speaker mixtures
WSJ_FS = 8000  # the "8k min" version
WSJ_SECONDS = (1.5, 10.0, 6.0, 1.9)  # least, most, mean and spread of a mixture's length (5 h in all)
WSJ_ROUND_S = 0.5  # lengths rounded to 0.5 s, so each batch holds one length and no clip is padded
WSJ_LEVELS_DB = 2.5  # the speakers mixed at relative levels drawn from -2.5 to 2.5 dB
WSJ_SI_SDR_DB = (5.0, 20.0)  # each estimate's planted SI-SDR: its source plus a leak of the other speaker and noise
WSJ_BATCH = 16  # mixtures an update, all of one length
WSJ_CPU_MIXTURES = 8  # the first mixtures, held against the port's CPU run
WSJ_STOI_EVERY = 40  # every 40th batch goes through STOI and ESTOI (cut: host-bound at 12-18 ms a clip and variant, 140-210 s for all)
WSJ_DENSE_EVERY = 4  # every 4th batch goes through the dense SDR (cut: 32 ms an update through cuSOLVER's LU), CG through all
WSJ_F64_SDR_EVERY = 8  # every 8th batch's dense SDR is held against float64 (a float64 LU of 512 x 512 per clip); SI-SDR's every batch
WSJ_CG_ITER = 10
# card against CPU, dB (STOI: its unit): 3.8e-6 read for the SNR family, PIT and the dense SDR, 1.8e-7 for STOI; CG's
# ten unconverged steps carry cuFFT's rounding against the CPU's into the SDR (0.13 dB read)
AUDIO_CPU_ATOL = {"si_sdr": 1e-4, "snr": 1e-4, "si_snr": 1e-4, "sdr": 1e-4, "sdr_cg": 0.5, "pit": 1e-4, "stoi": 1e-5, "estoi": 1e-5}
AUDIO_F64_ATOL = {"si_sdr": 1e-4, "sdr": 1e-4}  # dB, float32 on the card against the same formulas in float64 there (3.0e-6 read)
AUDIO_CG_DB = 8.0  # |SDR by 10 CG steps - SDR by the dense solve| of any clip, dB: unpreconditioned CG on voiced speech's ill-conditioned autocorrelation (2.7 dB mean, 5.9 max read on the CPU at 3 s)
AUDIO_MEAN_RTOL = 1e-5  # a module's compute() against the float64 mean of the per-clip values
AUDIO_PHASES_LIMIT_S = 45  # what audio_path and lockwitness_path may add together
AUDIO_PHASE_S = {}  # their seconds of command
WITNESS_WORLD = 2  # lockwitness_path's ranks: rank 0 serves, both read an overlapped sync
WITNESS_REQUESTS = 24
WITNESS_CLASSES = 1000


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}  # seconds since the script started
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def budget_time(bucket, name):
    """Adds the block's seconds to ``bucket[name]``: ``NEW_PHASE_S`` (the
    resilience and observability phases), ``SLICE_PHASE_S`` (the fleet and
    detection phases) or ``AUDIO_PHASE_S`` (the audio and lock-witness
    phases), which the ``budget`` line sums."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        bucket[name] = bucket.get(name, 0.0) + time.perf_counter() - t0


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
        # the port's own kernels, wherever they rank: time, and the card's
        # records of them (a kernel inside a replayed graph has its records too)
        "port_kernels_ms_per_batch": {
            name: sum(dev_us(e) for e in on_device if name in e.key) / 1e3 / batches
            for name in ("binned_counters_kernel", "histogram_kernel", "compactor_fold_kernel", "compactor_cascade_kernel")
        },
        "port_kernel_records_per_batch": {
            name: sum(e.count for e in on_device if name in e.key) / batches
            for name in ("binned_counters_kernel", "histogram_kernel", "compactor_cascade_kernel")
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
    (DL, DK), (IL, IK), (SL, SK) = DRIFT_SKETCH_SHAPE, ITEM_SKETCH_SHAPE, TELEMETRY_SKETCH_SHAPE

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
        # drift_path's live sketch (eps 0.01, max_items 2^25): 4096-row chunks
        # and a padded rest tier, all at level 0
        insert("drift_insert_chunk", DL, DK, rand_fill(DL, DK), 4096, 4093, 0),
        insert("drift_insert_chunk_promotes", DL, DK, [DK - 100] * 6 + rand_fill(DL - 6, DK), 4096, 4096, 0),
        insert("drift_insert_empty_state", DL, DK, [0] * DL, 4096, 4096, 0),
        insert("drift_insert_padded_rest_tier", DL, DK, [DK - 1] * 3 + rand_fill(DL - 3, DK), 1024, 700, 0),
        insert("drift_insert_ties_and_infinities", DL, DK, [DK - 20] * 8 + rand_fill(DL - 8, DK), 4096, 4096, 0, ties=True, extremes=True),
        merge("drift_merge", DL, DK, rand_fill(DL, DK), rand_fill(DL, DK)),
        merge("drift_merge_saturated", DL, DK, [DK] * DL, [DK] * DL),
        # the item-id monitor: a 4096-row chunk halves twice, to 1024 items at level 2
        insert("item_insert_chunk", IL, IK, rand_fill(IL, IK), 1024, 1024, 2),
        insert("item_insert_chunk_promotes", IL, IK, [IK] * 9 + rand_fill(IL - 9, IK), 1024, 1023, 2),
        insert("item_insert_padded_rest_tier", IL, IK, rand_fill(IL, IK), 1024, 517, 1),
        merge("item_merge", IL, IK, rand_fill(IL, IK), rand_fill(IL, IK)),
        # serving_obs_path's drift monitor (window 2^16) and the telemetry
        # histograms: a full 8192-sample fold lands 4096 items at level 1, a
        # scrape folds what is pending at level 0
        insert("serve_drift_insert_chunk", SL, SK, rand_fill(SL, SK), 4096, 4096, 0),
        insert("serve_drift_insert_padded_rest_tier", SL, SK, rand_fill(SL, SK), 64, 1, 0),
        insert("telemetry_fold_8192", SL, SK, [SK - 10] * 4 + rand_fill(SL - 4, SK), 4096, 4096, 1),
        insert("telemetry_fold_first", SL, SK, [0] * SL, 4096, 4096, 1),
        insert("telemetry_fold_at_scrape", SL, SK, rand_fill(SL, SK), 3000, 3000, 0),
        merge("telemetry_merge", SL, SK, rand_fill(SL, SK), rand_fill(SL, SK)),
        merge("telemetry_merge_saturated", SL, SK, [SK] * SL, [SK - 1] * SL),
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


def run_stream(coll, x, sync, batches=STREAM_BATCHES):
    """Every 16th batch through forward, the rest through update."""
    update_s, forward_s = [], []
    for i in range(batches):
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

    # the stream's first STREAM_CPU_BATCHES batches (two forwards among
    # them) on the card again and through the port on the CPU (cut from the
    # whole stream for the script's time; the whole stream is held against
    # exact answers below)
    head = build_monitor(mtt, dev)
    run_stream(head, x, torch.cuda.synchronize, batches=STREAM_CPU_BATCHES)
    head_result = head.compute()
    t2 = time.perf_counter()
    cpu = build_monitor(mtt, "cpu")
    run_stream(cpu, x[:STREAM_CPU_BATCHES * STREAM_BATCH].cpu(), lambda: None, batches=STREAM_CPU_BATCHES)
    cpu_result = cpu.compute()
    cpu_s = time.perf_counter() - t2
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    for name, m in dict(head.items(keep_base=True, copy_state=False)).items():
        for field, a, b in zip(m.metric_state["sketch"]._fields, m.metric_state["sketch"], cpu_members[name].metric_state["sketch"]):
            if a.dtype != b.dtype or not torch.equal(a.cpu().reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)):
                raise AssertionError(f"state {name}.sketch.{field} differs between the card and the CPU")
    if not torch.equal(head_result["q"].cpu(), cpu_result["q"]) or not torch.equal(head_result["freq"].cpu(), cpu_result["freq"]):
        raise AssertionError("compute() of q or freq differs between the card and the CPU")
    if not torch.allclose(head_result["distinct"].cpu(), cpu_result["distinct"], rtol=HLL_RTOL, atol=0.0):
        raise AssertionError(f"distinct {float(head_result['distinct'])} on the card, {float(cpu_result['distinct'])} on the CPU")
    del head

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
        "cpu_reference_batches": STREAM_CPU_BATCHES,
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


def run_world(target, label, world=DIST_WORLD):
    """Spawn the ranks of a path (``target(rank, world, port, results,
    device)``), collect what each reports, and stop every process."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, results, DIST_DEVICE)) for r in range(world)]
    return collect_processes(procs, results, label)


def collect_processes(procs, results, label):
    """Start ``procs`` (those not started yet), collect the ``(key, out)``
    each puts on ``results``, and stop every process; the outputs in the
    order of the keys."""
    got = {}
    try:
        for proc in procs:
            if proc.pid is None:
                proc.start()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while len(got) < len(procs):
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
        if codes != [0] * len(procs):
            raise AssertionError(f"{label}: rank exit codes {codes}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [got[k] for k in sorted(got)]


def mann_whitney_auroc(scores, labels):
    """The exact AUROC in float64, on the tensors' device: the positives'
    tie-averaged rank sum (every rank a multiple of 0.5 below 2^27, every
    partial sum below 2^52, so every sum is exact in any order)."""
    import torch

    ordered, order = torch.sort(scores.to(torch.float64))
    _, inverse, counts = torch.unique_consecutive(ordered, return_inverse=True, return_counts=True)
    counts = counts.to(torch.float64)
    avg_rank = torch.cumsum(counts, 0) - (counts - 1) / 2.0
    pos = labels[order] == 1
    n_pos = int(pos.sum())
    n_neg = labels.shape[0] - n_pos
    u = float(avg_rank[inverse][pos].sum()) - n_pos * (n_pos + 1) / 2.0
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
    # update, in the list mode (cut from both modes for the script's time:
    # the card's rings are held against the CPU's lists, which give the
    # same values); the exact float64 AUROC on the card
    scores, labels = make_dist_data(dev)
    t2 = time.perf_counter()
    exact = mann_whitney_auroc(scores, labels)
    exact_s = time.perf_counter() - t2
    cs, cl = scores.cpu(), labels.cpu()
    del scores, labels
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = mtt.MetricCollection({"auroc": mtt.AUROC(device="cpu"), "ap": mtt.AveragePrecision(device="cpu")})
    run_dist_batches(ref, cs, cl, lambda: None, forward_every=None)
    ref_values = ref.compute()
    cpu_s = time.perf_counter() - t1
    ref_curve = curve_digest(cs, cl)

    card = ranks[0]["values"]
    rel = {k: abs(card[k] - float(ref_values[k.replace("_ring", "")])) / abs(float(ref_values[k.replace("_ring", "")])) for k in card}
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
        "cpu_reference_members": "auroc and ap (the list mode); the card's rings are held against them",
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


_FUSED_EVAL_CPU = {}


def fused_eval_cpu_reference(preds, target):
    """The fused evaluation's collection over the epoch of
    :func:`make_fused_eval_data`, through the port on the CPU: its values
    and the seconds the run took. Made once a run, by whichever of
    ``sliced_path`` (its unsliced BAP) and ``fused_dist_path`` asks first."""
    import metrics_tpu_torch as mtt

    if not _FUSED_EVAL_CPU:
        t0 = time.perf_counter()
        ref = build_fused_eval(mtt, "cpu")
        run_fused_eval(ref, preds.cpu(), target.cpu(), lambda: None)
        _FUSED_EVAL_CPU.update(values=_values(ref.compute()), seconds=time.perf_counter() - t0)
    return _FUSED_EVAL_CPU["values"], _FUSED_EVAL_CPU["seconds"]


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
        # snapshot_path: the rank's local state, as a preempted evaluation writes it
        out["snapshot"] = save_rank_snapshot(mtt, coll, "fused_eval", rank, world)
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
        # the pure layer over the same world, then a quarter of the MovieLens split
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # BAP's "warn" policy reports the injected faults
            out.update(pure_world(mtt, dist, dev, p, y, sync))
        out.update(movielens_world(mtt, dist, dev, rank, world, sync))
        # the retrieval and sliced additions of this world
        out.update(retrieval_world(mtt, dist, dev, rank, world, sync))
        ids = torch.from_numpy(make_slice_ids(ROWS, BATCH, SLICES)[rank * shard:(rank + 1) * shard]).to(dev)
        out.update(sliced_world(mtt, dist, dev, p, y, ids, sync))
        # detection_path's F12 check: MeanAveragePrecision synced over the world
        out.update(detection_world(mtt, dist, dev, rank, world, sync))
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def phase_fused_eval(dev, pure_values, ml_values):
    import torch

    import metrics_tpu_torch as mtt

    snapshot_dir = tempfile.mkdtemp(prefix="chip_smoke_fused_eval_")
    os.environ[SNAPSHOT_DIR_ENV] = snapshot_dir
    try:
        return _phase_fused_eval(dev, pure_values, ml_values, snapshot_dir)
    finally:
        os.environ.pop(SNAPSHOT_DIR_ENV, None)
        shutil.rmtree(snapshot_dir, ignore_errors=True)


def _phase_fused_eval(dev, pure_values, ml_values, snapshot_dir):
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
    ref_values, cpu_s = fused_eval_cpu_reference(preds, target)
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
    check_pure_world(ranks, card, pure_values, ml_values)
    check_retrieval_sliced_world(ranks, dev)
    _DETECTION_WORLD[:] = [r["detection"] for r in ranks]  # checked in phase_detection
    with budget_time(NEW_PHASE_S, "snapshot_path"):
        check_elastic_restore(dev, snapshot_dir, ranks, card, ranks[0]["synced_faults"])
    return sum(r["launches"]["binned_counters"] for r in ranks), card


def check_pure_world(ranks, stateful, pure_values, ml_values):
    """The pure layer and the MovieLens quarter of the four-rank world:
    ``compute`` makes one ``all_reduce`` per bucket of the fused members,
    then the wrapper's own, and no gather, with the stateful values (the
    members that share its configuration) and the one-process pure values;
    a cycle is one fused sync and a read none, bit-equal to the fresh read;
    the regression collection gathers Pearson's moments and Spearman's
    rings and matches one process."""
    r0 = ranks[0]
    fused, wrapper = r0["pure_buckets"]["fused"], r0["pure_buckets"]["wrapper"]
    for r in ranks:
        calls = [c[0] for c in r["pure_all_reduce"]]
        if (r["pure_other"] or sorted(calls[:len(fused)]) != fused or sorted(calls[len(fused):]) != wrapper
                or any(c[1] != "SUM" for c in r["pure_all_reduce"])):
            raise AssertionError(f"pure_dist_path: rank {r['rank']} compute made {r['pure_all_reduce']} and {r['pure_other']}; "
                                 f"predicted the buckets {fused} then {wrapper}")
        if len(r["faults_collectives"]) != 1:
            raise AssertionError(f"pure_dist_path: rank {r['rank']} faults() made {r['faults_collectives']}")
        if r["cycle_other"] or sorted(c[0] for c in r["cycle_all_reduce"]) != sorted(set(fused + wrapper)):
            raise AssertionError(f"pure_dist_path: rank {r['rank']} cycle made {r['cycle_all_reduce']} and {r['cycle_other']}")
        if r["read_collectives"] or r["lag"] != 0 or not r["read_bit_equal_fresh"]:
            raise AssertionError(f"pure_dist_path: rank {r['rank']} read made {r['read_collectives']}, lag {r['lag']}, "
                                 f"bit-equal to the fresh read: {r['read_bit_equal_fresh']}")
        if r["pure_values"] != r0["pure_values"] or r["ml_values"] != r0["ml_values"] or r["pure_faults"] != r0["pure_faults"]:
            raise AssertionError(f"pure_dist_path: rank {r['rank']} computed other values than rank 0")
        if not any(c.startswith("all_gather") for c in r["ml_other"]):
            raise AssertionError(f"pure_dist_path: the regression collection gathered nothing: {r['ml_other']}")
        # the replicas' stacked state syncs in one collective per bucket
        if (r["boot_other"] or sorted(c[0] for c in r["boot_all_reduce"]) != r0["boot_buckets"]
                or len(r["boot_faults_collectives"]) != 1):
            raise AssertionError(f"pure_dist_path: rank {r['rank']} bootstrap compute made {r['boot_all_reduce']} and "
                                 f"{r['boot_other']}, faults {r['boot_faults_collectives']}; predicted the buckets {r0['boot_buckets']}")
        if r["boot_raw"] != r0["boot_raw"]:
            raise AssertionError(f"pure_dist_path: rank {r['rank']} bootstrapped other values than rank 0")
    for key in ("acc", "prec", "rec", "f1"):
        if r0["pure_values"][key] != [stateful[key]]:
            raise AssertionError(f"pure_dist_path: {key} {r0['pure_values'][key]} against the stateful {stateful[key]}")
    # the bootstrap estimates the guarded accuracy of the clean rows: the stateful collection's
    rows, top1 = sum(r["boot_rows"] for r in ranks), stateful["acc"]
    boot_mean, boot_std, binomial_std = r0["boot_mean"], r0["boot_std"], math.sqrt(top1 * (1 - top1) / rows)
    if len(r0["boot_raw"]) != BOOTSTRAPS or not all(math.isfinite(v) for v in r0["boot_raw"]):
        raise AssertionError(f"pure_dist_path: bootstrap raw values {r0['boot_raw'][:4]}... ({len(r0['boot_raw'])})")
    if abs(boot_mean - top1) > 3 * boot_std or not 0.5 <= boot_std / binomial_std <= 2.0:
        raise AssertionError(f"pure_dist_path: bootstrap mean {boot_mean}, std {boot_std} against top-1 {top1}, "
                             f"sqrt(p(1-p)/N) {binomial_std}")
    _values_close(r0["pure_values"], pure_values, 0.0, AP_ATOL, "pure_dist_path: four ranks against one process")
    _values_close(r0["ml_values"], ml_values, FLOAT_SUM_RTOL, 1e-6, "pure_dist_path: MovieLens over four ranks against one process")
    emit({
        "phase": "pure_dist_path",
        "config": {"world": DIST_WORLD, "rows": ROWS, "batch": BATCH, "members": ["acc", "prec", "rec", "f1", "bap", "per_class"],
                   "movielens_rows_per_rank": [r["ml_rows"] for r in ranks], "spearman_ring_per_rank": MOVIELENS_WORLD_RING,
                   "backend": "gloo, four processes on one card (loopback TCP; not NCCL)"},
        "compute_all_reduce": r0["pure_all_reduce"], "compute_s": [r["pure_compute_s"] for r in ranks],
        "buckets": {"fused": fused, "wrapper": wrapper},
        "cycle_all_reduce": r0["cycle_all_reduce"], "cycle_s": [r["cycle_s"] for r in ranks],
        "read_collectives": 0, "read_bit_equal_fresh": True,
        "synced_faults": r0["pure_faults"],
        "bootstrap": {"replicas": BOOTSTRAPS, "all_reduce": r0["boot_all_reduce"], "gathers": len(r0["boot_other"]),
                      "compute_s": [r["boot_s"] for r in ranks], "mean": boot_mean, "std": boot_std, "stateful_acc": top1,
                      "binomial_std": binomial_std},
        "acc": r0["pure_values"]["acc"][0], "bap_mean": statistics.mean(r0["pure_values"]["bap"]),
        "movielens": {"values": {k: v[0] for k, v in r0["ml_values"].items()}, "all_reduce": r0["ml_all_reduce"],
                      "gathers": len(r0["ml_other"]), "compute_s": [r["ml_compute_s"] for r in ranks],
                      "one_process": {k: v[0] for k, v in ml_values.items()}},
        "matches_one_process": True,
    })


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
        snapshot = save_rank_snapshot(mtt, coll, "fused_sketch", rank, world)
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
            "snapshot": snapshot,
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

    snapshot_dir = tempfile.mkdtemp(prefix="chip_smoke_fused_sketch_")
    os.environ[SNAPSHOT_DIR_ENV] = snapshot_dir
    try:
        t0 = time.perf_counter()
        ranks = run_world(fused_sketch_rank, "fused sketch path")
        world_s = time.perf_counter() - t0
        return _phase_fused_sketch(dev, ranks, world_s, snapshot_dir)
    finally:
        os.environ.pop(SNAPSHOT_DIR_ENV, None)
        shutil.rmtree(snapshot_dir, ignore_errors=True)


def _phase_fused_sketch(dev, ranks, world_s, snapshot_dir):
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import compactor as k3
    from metrics_tpu_torch.utilities.guard import FaultCounters

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
    with budget_time(NEW_PHASE_S, "snapshot_path"):
        restore_launches = check_sketch_restore(dev, snapshot_dir, ranks, folded)
    return sum(r["k3_insert_launches"] + r["k3_sync_launches"] for r in ranks), restore_launches


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


# ---------------------------------------------------------------------------
# the pure layer, the wrappers, regression and pairwise
# ---------------------------------------------------------------------------


def build_pure_eval(pkg, device):
    """The fused evaluation path's members for the pure layer, with a
    per-class recall through ``ClasswiseWrapper``. BAP counts its faults
    under ``"warn"``: under ``"drop"`` a binned metric boolean-indexes its
    rows, a read back that the pure layer refuses, as the JAX package's
    does inside compiled code."""
    kw = dict(num_classes=CLASSES, on_invalid="drop", device=device)
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(**kw),
        "prec": pkg.Precision(average="macro", **kw),
        "rec": pkg.Recall(average="macro", **kw),
        "f1": pkg.F1Score(average="macro", **kw),
        "bap": pkg.BinnedAveragePrecision(num_classes=CLASSES, thresholds=THRESHOLDS, on_invalid="warn", device=device),
        "per_class": pkg.ClasswiseWrapper(pkg.Recall(average=None, **kw)),
    })


def _tree_leaves(state, prefix=""):
    """A pure state's tensors by path: dict keys, list positions, tuple
    states by field."""
    if isinstance(state, dict):
        out = {}
        for k in sorted(state):
            out.update(_tree_leaves(state[k], f"{prefix}/{k}"))
        return out
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return {f"{prefix}.{f}": t for f, t in zip(state._fields, state)}
    if isinstance(state, list):
        out = {}
        for i, v in enumerate(state):
            out.update(_tree_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: state}


def _tree_bit_equal(a, b):
    import torch

    la, lb = _tree_leaves(a), _tree_leaves(b)
    if la.keys() != lb.keys():
        return False
    for k, x in la.items():
        y = lb[k]
        if x.dtype != y.dtype or x.shape != y.shape or x.device != y.device:
            return False
        if x.is_floating_point():
            view = {8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()]
            x, y = x.view(view), y.view(view)
        if not torch.equal(x, y):
            return False
    return True


def _tree_bytes(state):
    return sum(t.numel() * t.element_size() for t in _tree_leaves(state).values())


def _flat_values(values):
    """A collection's values as ``{key: [floats]}``."""
    import torch

    out = {}
    for k, v in values.items():
        t = torch.stack(v) if isinstance(v, list) else torch.as_tensor(v)
        out[k] = [float(x) for x in t.reshape(-1).cpu()]
    return out


def _stateful_tree(coll):
    """A stateful ``build_pure_eval`` collection's states in the pure layout."""
    members = dict(coll.items(keep_base=True, copy_state=False))
    return {
        name: [m.metric_state, m.metric.metric_state] if name == "per_class" else m.metric_state
        for name, m in members.items()
    }


def phase_pure(dev):
    """The ImageNet epoch of the fused evaluation path through
    ``functionalize(collection)``, against the stateful collection."""
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.pure import _owned_tree

    preds, target, nan_rows, label_rows = make_fused_eval_data(dev)
    starts = list(range(0, ROWS, BATCH))
    mdef = mtt.functionalize(build_pure_eval(mtt, dev))
    state = mdef.init()
    states, pure_s = [], []
    torch.cuda.synchronize()
    k1.reset_launch_count()
    for start in starts:
        before = _owned_tree(state)
        t0 = time.perf_counter()
        new = mdef.update(state, preds[start:start + BATCH], target[start:start + BATCH])
        torch.cuda.synchronize()
        pure_s.append(time.perf_counter() - t0)
        if not _tree_bit_equal(before, state):
            raise AssertionError(f"pure_path: the update of batch {len(states)} changed its input state")
        states.append(new)
        state = new
    launches = k1.launch_count
    if launches != len(starts):
        raise AssertionError(f"pure_path: K1 launched {launches} times over {len(starts)} pure updates")

    # the stateful collection on the same batches, state by state
    stateful = build_pure_eval(mtt, dev)
    stateful_s = []
    for i, start in enumerate(starts):
        t0 = time.perf_counter()
        stateful.update(preds[start:start + BATCH], target[start:start + BATCH])
        torch.cuda.synchronize()
        stateful_s.append(time.perf_counter() - t0)
        if not _tree_bit_equal(states[i], _stateful_tree(stateful)):
            raise AssertionError(f"pure_path: the pure state after batch {i} differs from the stateful collection's")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # BAP's "warn" policy reports the injected faults
        t0 = time.perf_counter()
        values = mdef.compute(state)
        torch.cuda.synchronize()
        compute_s = time.perf_counter() - t0
        want = stateful.compute()
    pure_values, stateful_values = _flat_values(values), _flat_values(want)
    if pure_values != stateful_values:
        raise AssertionError(f"pure_path: compute differs from the stateful compute(): {pure_values} against {stateful_values}")

    # two half-epoch states merged equal the whole-epoch state
    half = len(starts) // 2
    parts = []
    for chunk in (starts[:half], starts[half:]):
        s = mdef.init()
        for start in chunk:
            s = mdef.update(s, preds[start:start + BATCH], target[start:start + BATCH])
        parts.append(s)
    if not _tree_bit_equal(mdef.merge(*parts), state):
        raise AssertionError("pure_path: the merge of the two half-epoch states differs from the whole-epoch state")

    # the fault channel: each "drop" member the injected rows, BAP ("warn") the same faults with no row dropped
    dropped = nan_rows + label_rows
    want_drop = {"nonfinite_preds": nan_rows, "label_out_of_range": label_rows, "dropped_rows": dropped}
    want_warn = {"nonfinite_preds": nan_rows, "label_out_of_range": label_rows}
    members = {name: (s[1] if name == "per_class" else s) for name, s in state.items()}
    faults_by_member = {name: s["_faults"].as_dict() for name, s in members.items()}
    for name, got in faults_by_member.items():
        want_m = want_warn if name == "bap" else want_drop
        if {k: v for k, v in got.items() if v} != want_m:
            raise AssertionError(f"pure_path: {name} counted faults {got}, injected {want_m}")
    total = mdef.faults(state)
    summed = sum(s["_faults"].counts for s in members.values())
    if not torch.equal(total, summed):
        raise AssertionError(f"pure_path: faults() {total.tolist()} is not the members' sum {summed.tolist()}")

    # a guarded pure update reads nothing back to the host
    reads = blocking_reads(lambda i: mdef.update(state, preds[i * BATCH:(i + 1) * BATCH], target[i * BATCH:(i + 1) * BATCH]), GUARDED_UPDATES)
    if reads:
        raise AssertionError(f"pure_path: {len(reads)} blocking reads in {GUARDED_UPDATES} guarded pure updates: {reads[:3]}")
    emit({
        "phase": "pure_path",
        "config": {"rows": ROWS, "classes": CLASSES, "batch": BATCH, "thresholds": THRESHOLDS, "fault_share": FAULT_SHARE,
                   "members": list(state), "seed": SEED},
        "batches": len(starts),
        "k1_launches": launches,
        "pure_update_p50_ms": statistics.median(pure_s) * 1e3,
        "stateful_update_p50_ms": statistics.median(stateful_s) * 1e3,
        "pure_update_bytes_copied": _tree_bytes(state),
        "pure_compute_s": compute_s,
        "blocking_reads_per_guarded_update": len(reads) / GUARDED_UPDATES,
        "states_equal_stateful_after_every_batch": True,
        "inputs_unchanged": True,
        "merge_of_halves_equals_epoch": True,
        "injected": {"nonfinite_preds": nan_rows, "label_out_of_range": label_rows},
        "faults_by_member": faults_by_member,
        "acc": pure_values["acc"][0], "prec": pure_values["prec"][0], "rec": pure_values["rec"][0], "f1": pure_values["f1"][0],
        "bap_mean": statistics.mean(pure_values["bap"]),
    })
    return launches, pure_values


def phase_bootstrap(preds, target):
    """``bootstrap_functionalize(Accuracy)`` over the ImageNet epoch with a
    generator on the card: the vmapped update against one update per
    replica, and the bootstrap's mean and spread against the epoch."""
    import torch

    import metrics_tpu_torch as mtt

    dev = preds.device
    metric = mtt.Accuracy(num_classes=CLASSES, device=dev)
    bdef, mdef = mtt.bootstrap_functionalize(metric, BOOTSTRAPS), mtt.functionalize(metric)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    # the first and the last (ragged) batch: the vmapped update against
    # BOOTSTRAPS separate updates on the same indices, bit for bit
    checked = 0
    for start in (0, (ROWS // BATCH) * BATCH):
        p, y = preds[start:start + BATCH], target[start:start + BATCH]
        n = p.shape[0]
        idx = torch.randint(0, n, (BOOTSTRAPS, n), generator=gen, device=dev)
        vm = bdef.update.with_indices(bdef.init(), idx, p, y)
        for r in range(BOOTSTRAPS):
            one = mdef.update(mdef.init(), p[idx[r]], y[idx[r]])
            if not _tree_bit_equal({k: v[r] for k, v in vm.items()}, one):
                raise AssertionError(f"bootstrap_path: replica {r} of the vmapped update differs from its own update")
            checked += 1

    state, update_s = bdef.init(), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for start in range(0, ROWS, BATCH):
        t0 = time.perf_counter()
        state = bdef.update(state, gen, preds[start:start + BATCH], target[start:start + BATCH])
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
    out = bdef.compute(state)
    mean, std = float(out["mean"]), float(out["std"])
    top1 = float((preds.argmax(dim=1) == target).to(torch.float64).mean())
    expected_std = math.sqrt(top1 * (1 - top1) / ROWS)
    if out["raw"].shape != (BOOTSTRAPS,) or not bool(torch.isfinite(out["raw"]).all()):
        raise AssertionError(f"bootstrap_path: raw values of shape {tuple(out['raw'].shape)}")
    if abs(mean - top1) > 3 * std:
        raise AssertionError(f"bootstrap_path: mean {mean} is more than 3 std ({std}) from the epoch's top-1 {top1}")
    if not 0.5 <= std / expected_std <= 2.0:
        raise AssertionError(f"bootstrap_path: std {std} against sqrt(p(1-p)/N) = {expected_std}")
    emit({
        "phase": "bootstrap_path",
        "config": {"rows": ROWS, "classes": CLASSES, "batch": BATCH, "replicas": BOOTSTRAPS, "generator": "torch.Generator on the card", "seed": SEED + 20},
        "replicas_checked_bit_equal": checked,
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "epoch_s": sum(update_s),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "mean": mean, "std": std, "top1": top1, "binomial_std": expected_std, "std_ratio": std / expected_std,
    })


def make_movielens(device):
    """The held-out ratings on the half-star grid, drawn with ml-20m's
    shares of each rating (mean 3.5255), and a standard normal draw per
    row, from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 30)
    grid = torch.arange(1, 11, device=device, dtype=torch.float32) / 2
    weights = torch.tensor(MOVIELENS_RATING_COUNTS, dtype=torch.float32, device=device)
    target = grid[torch.multinomial(weights, MOVIELENS_ROWS, replacement=True, generator=g)]
    noise = torch.randn(MOVIELENS_ROWS, generator=g, device=device)
    return target, noise


def movielens_preds(target, noise, scale):
    import torch

    return torch.clamp(target + scale * noise, 0.5, 5.0)


def build_movielens(pkg, device, generator):
    kw = dict(device=device)
    return pkg.MetricCollection({
        "rmse": pkg.MeanSquaredError(squared=False, **kw),
        "mae": pkg.MeanAbsoluteError(**kw),
        "msle": pkg.MeanSquaredLogError(**kw),
        "mape": pkg.MeanAbsolutePercentageError(**kw),
        "smape": pkg.SymmetricMeanAbsolutePercentageError(**kw),
        "wmape": pkg.WeightedMeanAbsolutePercentageError(**kw),
        "pearson": pkg.PearsonCorrCoef(**kw),
        "spearman": pkg.SpearmanCorrCoef(capacity=MOVIELENS_RING, **kw),
        "r2": pkg.R2Score(**kw),
        "ev": pkg.ExplainedVariance(**kw),
        "tweedie": pkg.TweedieDevianceScore(power=1.5, **kw),
        "rmse_range": pkg.MinMaxMetric(pkg.MeanSquaredError(squared=False, **kw)),
        "rmse_boot": pkg.BootStrapper(pkg.MeanSquaredError(squared=False, **kw), num_bootstraps=MOVIELENS_BOOTSTRAPS, generator=generator),
    })


def build_movielens_world(pkg, device, capacity):
    """The four-rank MovieLens collection: Pearson's stacked moments,
    Spearman's rings, and two sum metrics."""
    kw = dict(device=device)
    return pkg.MetricCollection({
        "pearson": pkg.PearsonCorrCoef(**kw),
        "spearman": pkg.SpearmanCorrCoef(capacity=capacity, **kw),
        "r2": pkg.R2Score(**kw),
        "mse": pkg.MeanSquaredError(**kw),
    })


def run_movielens(device, target, noise, sync):
    """Three tracked epochs over the held-out split, the prediction noise
    shrinking; returns the tracker, per-batch seconds and compute seconds."""
    import torch

    import metrics_tpu_torch as mtt

    gen = torch.Generator().manual_seed(SEED + 31)  # resamples drawn on the host for both runs
    tracker = mtt.MetricTracker(build_movielens(mtt, device, gen), maximize=False)
    update_s, compute_s = [], []
    for scale in MOVIELENS_NOISE:
        tracker.increment()
        preds = movielens_preds(target, noise, scale)
        for start in range(0, MOVIELENS_ROWS, MOVIELENS_BATCH):
            t0 = time.perf_counter()
            tracker.update(preds[start:start + MOVIELENS_BATCH], target[start:start + MOVIELENS_BATCH])
            sync()
            update_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tracker.compute()
        sync()
        compute_s.append(time.perf_counter() - t0)
    return tracker, update_s, compute_s


def _values_close(card, cpu, rtol, atol, what):
    for k in cpu:
        a, b = card[k], cpu[k]
        if len(a) != len(b) or any(not math.isfinite(x) for x in a) or any(abs(x - y) > atol + rtol * abs(y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: {k} = {a} against {b} (rtol {rtol}, atol {atol})")


def make_qm9(device):
    """QM9-shaped targets (the 10 % test split, 12 regression targets),
    each on its own scale, and a model's predictions."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 40)
    scale = torch.exp(torch.randn(QM9_TARGETS, generator=g, device=device))
    target = torch.randn((QM9_ROWS, QM9_TARGETS), generator=g, device=device) * scale
    preds = target + 0.1 * scale * torch.randn((QM9_ROWS, QM9_TARGETS), generator=g, device=device)
    return preds, target


def phase_regression(dev):
    """MovieLens-20M's held-out split through the regression collection
    under ``MetricTracker``, on the card and on the CPU, and a QM9-shaped
    multi-target check."""
    import numpy as np
    import scipy.stats
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.functional.regression.spearman import _rank_data

    target, noise = make_movielens(dev)
    if abs(float(target.mean()) - 3.5) > 0.1:
        raise AssertionError(f"regression_path: seeded ratings have mean {float(target.mean())}")
    t0 = time.perf_counter()
    card, update_s, compute_s = run_movielens(dev, target, noise, torch.cuda.synchronize)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu, _, _ = run_movielens("cpu", target.cpu(), noise.cpu(), lambda: None)
    cpu_s = time.perf_counter() - t0

    card_all = {k: [float(x) for x in v.reshape(-1).cpu()] for k, v in card.compute_all().items()}
    cpu_all = {k: [float(x) for x in v.reshape(-1)] for k, v in cpu.compute_all().items()}
    _values_close(card_all, cpu_all, FLOAT_SUM_RTOL, 1e-6, "regression_path: card against CPU")
    last_card = dict(card._metrics[-1].items(keep_base=True, copy_state=False))
    last_cpu = dict(cpu._metrics[-1].items(keep_base=True, copy_state=False))
    for name, m in last_card.items():
        for key, value in m.metric_state.items():
            if isinstance(value, tuple) or value.is_floating_point():
                continue
            if not torch.equal(value.cpu(), last_cpu[name].metric_state[key]):
                raise AssertionError(f"regression_path: count {name}.{key} differs between the card and the CPU")
    ring_card, ring_cpu = last_card["spearman"].metric_state, last_cpu["spearman"].metric_state
    for key in ("preds", "target"):
        if not torch.equal(_rank_data(ring_card[key].data, ring_card[key].mask).cpu(), _rank_data(ring_cpu[key].data, ring_cpu[key].mask)):
            raise AssertionError(f"regression_path: Spearman's ranks of {key} differ between the card and the CPU")
    steps, best = card.best_metric(return_step=True)
    if steps["rmse"] != len(MOVIELENS_NOISE) - 1 or best["rmse"] != card_all["rmse"][-1]:
        raise AssertionError(f"regression_path: best RMSE {best['rmse']} at epoch {steps['rmse']}")

    # the last epoch against float64 on the card's draw
    p64 = movielens_preds(target, noise, MOVIELENS_NOISE[-1]).cpu().numpy().astype(np.float64)
    t64 = target.cpu().numpy().astype(np.float64)
    f64 = {
        "rmse": float(np.sqrt(np.mean((p64 - t64) ** 2))),
        "pearson": float(np.corrcoef(p64, t64)[0, 1]),
        "spearman": float(scipy.stats.spearmanr(p64, t64)[0]),
    }
    f64_err = {k: abs(card_all[k][-1] - v) for k, v in f64.items()}
    if max(f64_err.values()) > REG_F64_ATOL:
        raise AssertionError(f"regression_path: against float64 {f64_err} (atol {REG_F64_ATOL})")

    # the four-rank check's reference: one process over every row
    world_ref = build_movielens_world(mtt, dev, MOVIELENS_RING)
    p_last = movielens_preds(target, noise, MOVIELENS_NOISE[-1])
    for start in range(0, MOVIELENS_ROWS, MOVIELENS_BATCH):
        world_ref.update(p_last[start:start + MOVIELENS_BATCH], target[start:start + MOVIELENS_BATCH])
    world_values = {k: [float(v)] for k, v in world_ref.compute().items()}

    # QM9-shaped multi-target regression
    qp, qt = make_qm9(dev)
    qm9 = {}
    for device in (dev, "cpu"):
        coll = mtt.MetricCollection({
            "mae": mtt.MultioutputWrapper(mtt.MeanAbsoluteError(device=device), num_outputs=QM9_TARGETS),
            "cos": mtt.CosineSimilarity(reduction="mean", device=device),
        })
        times = []
        for start in range(0, QM9_ROWS, QM9_BATCH):
            t0 = time.perf_counter()
            coll.update(qp[start:start + QM9_BATCH].to(device), qt[start:start + QM9_BATCH].to(device))
            if device == dev:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        vals = coll.compute()
        qm9[str(device)] = {"values": {"mae": [float(v) for v in vals["mae"]], "cos": [float(vals["cos"])]},
                            "update_p50_ms": statistics.median(times) * 1e3, "rows_per_s": QM9_ROWS / sum(times),
                            "compute_s": time.perf_counter() - t0}
    q_card, q_cpu = qm9[str(dev)]["values"], qm9["cpu"]["values"]
    _values_close(q_card, q_cpu, FLOAT_SUM_RTOL, 1e-6, "regression_path (QM9): card against CPU")
    qp64, qt64 = qp.cpu().numpy().astype(np.float64), qt.cpu().numpy().astype(np.float64)
    q64 = {"mae": list(np.abs(qp64 - qt64).mean(axis=0)),
           "cos": [float(np.mean((qp64 * qt64).sum(1) / (np.linalg.norm(qp64, axis=1) * np.linalg.norm(qt64, axis=1))))]}
    _values_close(q_card, q64, REG_F64_RTOL, 1e-6, "regression_path (QM9): card against float64")

    batches = -(-MOVIELENS_ROWS // MOVIELENS_BATCH)
    emit({
        "phase": "regression_path",
        "config": {"ratings": MOVIELENS_RATINGS, "held_out_rows": MOVIELENS_ROWS, "batch": MOVIELENS_BATCH, "batches_per_epoch": batches,
                   "last_batch": MOVIELENS_ROWS - (batches - 1) * MOVIELENS_BATCH, "epochs_noise": list(MOVIELENS_NOISE),
                   "spearman_capacity": MOVIELENS_RING, "bootstraps": MOVIELENS_BOOTSTRAPS, "members": list(last_card), "seed": SEED + 30},
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "rows_per_s": len(MOVIELENS_NOISE) * MOVIELENS_ROWS / sum(update_s),
        "compute_s": compute_s,
        "card_s": card_s, "cpu_s": cpu_s,
        "values_last_epoch": {k: v[-1] for k, v in card_all.items()},
        "best_rmse_epoch": steps["rmse"],
        "float64": f64, "float64_abs_err": f64_err,
        "matches_cpu_run": True,
        "qm9": {"rows": QM9_ROWS, "targets": QM9_TARGETS, "batch": QM9_BATCH, "mae": q_card["mae"], "cos": q_card["cos"][0],
                "update_p50_ms": qm9[str(dev)]["update_p50_ms"], "rows_per_s": qm9[str(dev)]["rows_per_s"],
                "compute_s": qm9[str(dev)]["compute_s"], "matches_cpu_run": True},
    })
    return world_values


def phase_pairwise(dev):
    """The four pairwise functions on BERT-base-wide embeddings on the
    card, against float64 on the CPU over a block of rows."""
    import torch

    import metrics_tpu_torch.functional.pairwise as pw

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("pairwise_path: TF32 matmuls are on; the products must run in float32")
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    x = torch.randn((PAIR_N, PAIR_D), generator=g, device=dev)
    y = torch.randn((PAIR_M, PAIR_D), generator=g, device=dev)
    xr, x64, y64 = slice(0, PAIR_CHECK_ROWS), x.cpu().double(), y.cpu().double()

    def ref(name, a, b, zero_diag):
        a = a[xr]
        if name == "pairwise_cosine_similarity":
            d = (a / a.norm(dim=1, keepdim=True)) @ (b / b.norm(dim=1, keepdim=True)).T
        elif name == "pairwise_euclidean_distance":
            d = torch.cdist(a, b)
        elif name == "pairwise_linear_similarity":
            d = a @ b.T
        else:
            d = torch.cdist(a, b, p=1.0)
        if zero_diag:
            d[torch.arange(d.shape[0]), torch.arange(d.shape[0])] = 0.0
        return d

    rows = []
    for name in ("pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity", "pairwise_manhattan_distance"):
        fn = getattr(pw, name)
        for label, args, b64, zero_diag in (("x_x", (x,), x64, True), ("x_y", (x, y), y64, False)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn(*args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = cuda_time_ms(lambda: fn(*args), iters=10, warmup=2)
            want = ref(name, x64, b64, zero_diag)
            err = float((out[xr].cpu().double() - want).abs().max())
            tol = PAIR_ATOL[name]
            if out.shape != (PAIR_N, args[-1].shape[0]) or out.dtype != torch.float32 or not (err <= tol):
                raise AssertionError(f"pairwise_path: {name} {label}: shape {tuple(out.shape)}, max abs err {err} (atol {tol})")
            rows.append({"fn": name, "inputs": label, "shape": list(out.shape), "ms": ms, "peak_mem_bytes": peak,
                         "max_abs_err_vs_float64": err, "atol": tol})
            del out
    emit({"phase": "pairwise_path", "config": {"n": PAIR_N, "m": PAIR_M, "d": PAIR_D, "checked_rows": PAIR_CHECK_ROWS,
                                                "tf32": False, "seed": SEED + 50}, "calls": rows})


def _values_tree(values):
    """A collection's values with each list stacked: a tree of tensors."""
    import torch

    return {k: torch.stack(v) if isinstance(v, list) else torch.as_tensor(v) for k, v in values.items()}


def pure_world(mtt, dist, dev, p, y, sync):
    """One rank of the pure layer over the fused evaluation world: the
    collection's compute and fault counts over the group, the overlapped
    form's cycle, read and fresh read, then the bootstrap's compute."""
    import torch

    group = dist.group.WORLD
    coll = build_pure_eval(mtt, dev)
    cdef = mtt.functionalize(coll, group=group)
    state = cdef.init()
    for start in range(0, p.shape[0], BATCH):
        state = cdef.update(state, p[start:start + BATCH], y[start:start + BATCH])
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    with CollectiveRecorder() as rec:
        values = cdef.compute(state)
        sync()
    compute_s = time.perf_counter() - t0
    with CollectiveRecorder() as frec:
        faults = cdef.faults(state)
        sync()

    def dtypes(tree):
        return sorted({str(t.dtype).replace("torch.", "") for t in _tree_leaves(tree).values()})

    odef = mtt.overlapped_functionalize(coll, group=group)
    ostate = odef.init()
    for start in range(0, p.shape[0], BATCH):
        ostate = odef.update(ostate, p[start:start + BATCH], y[start:start + BATCH])
    sync()
    dist.barrier()
    t1 = time.perf_counter()
    with CollectiveRecorder() as cyc:
        ostate = odef.cycle(ostate)
        sync()
    cycle_s = time.perf_counter() - t1
    with CollectiveRecorder() as rd:
        read = odef.read(ostate)
        lag = int(odef.lag(ostate))
        sync()
    fresh = odef.read_fresh(ostate)

    bdef = mtt.bootstrap_functionalize(mtt.Accuracy(num_classes=CLASSES, on_invalid="drop", device=dev), BOOTSTRAPS, group=group)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60 + dist.get_rank())
    bstate = bdef.init()
    for start in range(0, p.shape[0], BATCH):
        bstate = bdef.update(bstate, gen, p[start:start + BATCH], y[start:start + BATCH])
    sync()
    dist.barrier()
    t2 = time.perf_counter()
    with CollectiveRecorder() as brec:
        boot = bdef.compute(bstate)
        sync()
    boot_s = time.perf_counter() - t2
    with CollectiveRecorder() as bfrec:
        bdef.faults(bstate)
        sync()
    return {
        "pure_all_reduce": rec.all_reduce, "pure_other": rec.other, "pure_compute_s": compute_s,
        "pure_buckets": {"fused": dtypes({k: v for k, v in state.items() if k != "per_class"}), "wrapper": dtypes(state["per_class"])},
        "pure_values": _flat_values(values), "pure_faults": [int(v) for v in faults.cpu()],
        "faults_collectives": frec.all_reduce + frec.other,
        "cycle_all_reduce": cyc.all_reduce, "cycle_other": cyc.other, "cycle_s": cycle_s,
        "read_collectives": rd.all_reduce + rd.other, "lag": lag,
        "read_bit_equal_fresh": _tree_bit_equal(_values_tree(read), _values_tree(fresh)),
        "boot_all_reduce": brec.all_reduce, "boot_other": brec.other, "boot_s": boot_s, "boot_buckets": dtypes(bstate),
        "boot_faults_collectives": bfrec.all_reduce + bfrec.other,
        "boot_raw": [float(v) for v in boot["raw"].cpu()], "boot_mean": float(boot["mean"]), "boot_std": float(boot["std"]),
        "boot_rows": int((torch.isfinite(p).all(dim=1) & (y < CLASSES)).sum()),  # the rows "drop" keeps
    }


def movielens_world(mtt, dist, dev, rank, world, sync):
    """One rank's quarter of the MovieLens split through the four-rank
    regression collection, and its synced compute."""
    target, noise = make_movielens(dev)
    preds = movielens_preds(target, noise, MOVIELENS_NOISE[-1])
    shard = -(-MOVIELENS_ROWS // world)
    p, t = preds[rank * shard:(rank + 1) * shard], target[rank * shard:(rank + 1) * shard]
    coll = build_movielens_world(mtt, dev, MOVIELENS_WORLD_RING)
    for start in range(0, p.shape[0], MOVIELENS_BATCH):
        coll.update(p[start:start + MOVIELENS_BATCH], t[start:start + MOVIELENS_BATCH])
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    with CollectiveRecorder() as rec:
        values = coll.compute()
        sync()
    return {
        "ml_rows": int(p.shape[0]), "ml_values": {k: [float(v)] for k, v in values.items()},
        "ml_all_reduce": rec.all_reduce, "ml_other": rec.other, "ml_compute_s": time.perf_counter() - t0,
    }


# ----------------------------------------------------------------------
# retrieval: an MS MARCO passage-ranking dev evaluation
# ----------------------------------------------------------------------


def make_msmarco():
    """The MS MARCO dev "small" shape, drawn with numpy on the host:
    ``MSMARCO_QUERIES`` queries whose BM25 candidate counts sum to
    ``MSMARCO_ROWS`` (most 1000, some fewer); ``MSMARCO_RECALL`` of the
    queries hold a relevant candidate, 7 % of those two; N(0, 1) scores,
    N(``MSMARCO_MU``, 1) for relevant ones. Rows grouped by query, as in
    ``top1000.dev``. Returns int32 ids, float32 scores, int32 targets and
    the per-query counts, all numpy."""
    import numpy as np

    rng = np.random.default_rng(SEED + 70)
    q = MSMARCO_QUERIES
    counts = np.full(q, MSMARCO_DEPTH, np.int64)
    deficit = q * MSMARCO_DEPTH - MSMARCO_ROWS
    short = rng.choice(q, size=MSMARCO_SHORT_QUERIES, replace=False)
    cut = rng.integers(1, MSMARCO_DEPTH, short.shape[0])  # each short query keeps 1..999
    while cut.sum() != deficit:
        step = 1 if cut.sum() < deficit else -1
        room = np.nonzero((cut + step >= 1) & (cut + step <= MSMARCO_DEPTH - 1))[0]
        cut[room[:abs(int(deficit - cut.sum()))]] += step
    counts[short] -= cut
    starts = np.cumsum(counts) - counts
    has_rel = rng.random(q) < MSMARCO_RECALL
    two = has_rel & (rng.random(q) < MSMARCO_SECOND_REL) & (counts > 1)
    first = (rng.random(q) * counts).astype(np.int64)
    second = (first + 1 + (rng.random(q) * (counts - 1)).astype(np.int64)) % counts
    target = np.zeros(MSMARCO_ROWS, np.int32)
    target[(starts + first)[has_rel]] = 1
    target[(starts + second)[two]] = 1
    preds = rng.standard_normal(MSMARCO_ROWS, dtype=np.float32) + np.float32(MSMARCO_MU) * target
    idx = np.repeat(np.arange(q, dtype=np.int32), counts)
    return idx, preds.astype(np.float32), target, counts


def msmarco_bounds(counts):
    """Row offsets of the batches: ``MSMARCO_QUERY_BATCH`` whole queries each."""
    import numpy as np

    ends = np.cumsum(counts)
    return [0] + [int(ends[min(q + MSMARCO_QUERY_BATCH, MSMARCO_QUERIES) - 1]) for q in range(0, MSMARCO_QUERIES, MSMARCO_QUERY_BATCH)]


def build_retrieval(pkg, device, capacity=None, names=None, pad=False):
    """The evaluation's metrics by name, in the list mode or, with
    ``capacity``, the capacity mode (with ``pad``, padded up the ladder)."""
    mode = {} if capacity is None else {"capacity": capacity, "num_queries": MSMARCO_QUERIES, "max_docs_per_query": MSMARCO_DEPTH}
    if pad:
        mode["pad_batches"] = True
    kw = dict(device=device, **mode)
    make = {
        "mrr": lambda: pkg.RetrievalMRR(**kw),
        "map": lambda: pkg.RetrievalMAP(**kw),
        "ndcg@10": lambda: pkg.RetrievalNormalizedDCG(k=10, **kw),
        "p@10": lambda: pkg.RetrievalPrecision(k=10, **kw),
        "r@100": lambda: pkg.RetrievalRecall(k=100, **kw),
        "hit@10": lambda: pkg.RetrievalHitRate(k=10, **kw),
        "fallout@10": lambda: pkg.RetrievalFallOut(k=10, **kw),
        "rprec": lambda: pkg.RetrievalRPrecision(**kw),
        "pr_curve@100": lambda: pkg.RetrievalPrecisionRecallCurve(max_k=100, **kw),
        "r@p0.1": lambda: pkg.RetrievalRecallAtFixedPrecision(min_precision=0.1, max_k=100, **kw),
    }
    return {name: make[name]() for name in (names or make)}


def run_retrieval(metrics, idx, preds, target, bounds, sync):
    """Every batch through every metric, then each ``compute()``."""
    update_s = []
    for a, z in zip(bounds[:-1], bounds[1:]):
        t0 = time.perf_counter()
        for m in metrics.values():
            m.update(preds[a:z], target[a:z], indexes=idx[a:z])
        sync()
        update_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    values = {name: m.compute() for name, m in metrics.items()}
    sync()
    return update_s, values, time.perf_counter() - t0


def _retrieval_values(values):
    """``{name: [floats]}``; a curve's three tensors concatenated."""
    out = {}
    for k, v in values.items():
        parts = v if isinstance(v, tuple) else (v,)
        out[k] = [float(x) for p in parts for x in p.reshape(-1).cpu()]
    return out


def retrieval_per_query(metrics, idx, preds, target):
    """The exact metrics' per-query values, ``(num_queries,)`` each: the
    list mode's grouped values, the capacity mode's row kernel over its
    dense layout."""
    out = {}
    for name in RETRIEVAL_EXACT:
        m = metrics[name]
        if m.capacity is None:
            out[name] = m._per_query_values(idx, preds, target)
        else:
            out[name] = m._row_metric(*m._grouped_capacity_matrices())
    return out


def msmarco_float64(idx, preds, target, counts):
    """MRR, MAP and nDCG@10 of the draw in float64 numpy: documents ranked
    by descending score, ties in row order."""
    import numpy as np

    n = idx.shape[0]
    order = np.lexsort((np.arange(n), -preds.astype(np.float64), idx))
    st = target[order].astype(np.float64)
    starts = np.cumsum(counts) - counts
    rank = np.arange(n) - np.repeat(starts, counts) + 1.0
    n_rel = np.add.reduceat(st, starts)
    first = np.minimum.reduceat(np.where(st > 0, rank, np.inf), starts)
    rr = np.where(n_rel > 0, 1.0 / first, 0.0)
    hits = np.cumsum(st)
    hits_in_query = hits - np.repeat(hits[starts] - st[starts], counts)
    ap = np.where(n_rel > 0, np.add.reduceat(hits_in_query / rank * st, starts) / np.maximum(n_rel, 1), 0.0)
    dcg = np.add.reduceat(np.where(rank <= 10, st / np.log2(rank + 1.0), 0.0), starts)
    ideal_rank = np.arange(1, 11, dtype=np.float64)
    idcg = np.array([np.sum(1.0 / np.log2(ideal_rank[:int(min(r, 10))] + 1.0)) for r in n_rel])
    ndcg = np.where(idcg > 0, dcg / np.where(idcg > 0, idcg, 1.0), 0.0)
    return {"mrr": float(rr.mean()), "map": float(ap.mean()), "ndcg@10": float(ndcg.mean())}


def phase_retrieval(dev):
    """The MS MARCO evaluation in both modes on the card, against the same
    run on the CPU, each other and float64 numpy; K1-K3 launch nowhere on
    it. Returns the card's list-mode values (the four-rank check's
    reference is computed after the world)."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import compactor as k3
    from metrics_tpu_torch.ops import histogram as k2

    t_start = time.perf_counter()
    idx_np, p_np, t_np, counts = make_msmarco()
    bounds = msmarco_bounds(counts)
    idx, preds, target = (torch.from_numpy(x).to(dev) for x in (idx_np, p_np, t_np))
    modes = (("list", None), ("capacity", MSMARCO_CAPACITY))
    card, perq, report = {}, {}, {}
    for kernel in (k1, k2, k3):
        kernel.reset_launch_count()
    for mode, cap in modes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        metrics = build_retrieval(mtt, dev, cap)
        update_s, values, compute_s = run_retrieval(metrics, idx, preds, target, bounds, torch.cuda.synchronize)
        peak = torch.cuda.max_memory_allocated(dev) - base
        card[mode] = _retrieval_values(values)
        perq[mode] = retrieval_per_query(metrics, idx, preds, target)
        if cap is not None:
            # snapshot_path (b): the rings of the whole split saved and restored
            with budget_time(NEW_PHASE_S, "snapshot_path"):
                check_large_state(dev, metrics, {name: metrics[name]._row_metric(*metrics[name]._grouped_capacity_matrices())
                                                 for name in MSMARCO_WORLD_METRICS})
        report[mode] = {
            "update_p50_ms": statistics.median(update_s) * 1e3,
            "rows_per_s": MSMARCO_ROWS / sum(update_s),
            "compute_s": compute_s,
            "peak_memory_bytes": peak,
        }
        del metrics
    # the capacity mode padded up the ladder (its rings take the pad mask),
    # so every batch meets one captured graph, beside its eager twin: the
    # values bit-equal to each other and to the unpadded capacity mode's
    for name, captured in (("capacity_padded_captured", True), ("capacity_padded_eager", False)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        metrics = build_retrieval(mtt, dev, MSMARCO_CAPACITY, pad=True)
        if not captured:
            for m in metrics.values():
                object.__setattr__(m, "jittable_update", False)
        update_s, values, compute_s = run_retrieval(metrics, idx, preds, target, bounds, torch.cuda.synchronize)
        report[name] = {
            "update_p50_ms": statistics.median(update_s) * 1e3,
            "update_p99_ms": _p(update_s, 99),
            "rows_per_s": MSMARCO_ROWS / sum(update_s),
            "compute_s": compute_s,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) - base,
        }
        if _retrieval_values(values) != card["capacity"]:
            raise AssertionError(f"retrieval_path: {name} values differ from the unpadded capacity mode's")
        if captured:
            stats = graph_stats(metrics)
            if any(not st["jittable_update"] or not st["replays"] for st in stats.values()):
                raise AssertionError(f"retrieval_path: a padded capacity-mode metric is not replaying its captured update: {stats}")
            report[name]["graphs"] = {k: {f: st[f] for f in ("captures", "replays", "eager_updates")} for k, st in stats.items()}
            report[name]["graph_pool_bytes"] = graph_pool_bytes(metrics.values())
        del metrics, values
    launches = {"binned_counters": k1.launch_count, "histogram": k2.launch_count, "compactor_fold": k3.launch_count}
    if any(launches.values()):
        raise AssertionError(f"retrieval_path: kernels launched {launches}; retrieval groups by sorts")

    # the capacity update reads nothing back
    m = mtt.RetrievalMRR(capacity=MSMARCO_CAPACITY, num_queries=MSMARCO_QUERIES, device=dev)
    reads = blocking_reads(lambda i: m.update(preds[bounds[i]:bounds[i + 1]], target[bounds[i]:bounds[i + 1]],
                                              indexes=idx[bounds[i]:bounds[i + 1]]), GUARDED_UPDATES)
    if reads:
        raise AssertionError(f"retrieval_path: {len(reads)} blocking reads in {GUARDED_UPDATES} capacity updates: {reads[:3]}")
    del m

    # the same draw through the port on the CPU, in the list mode only (the
    # CPU's capacity-mode run is cut for the script's time: the card's
    # capacity mode is held against this run, the card's list mode and
    # float64): the metrics in one collection, whose single compute group
    # updates once a batch; an exact metric's value is the mean of its
    # per-query values (what its compute() takes)
    t_cpu = time.perf_counter()
    ci, cp, ct = (torch.from_numpy(x) for x in (idx_np, p_np, t_np))
    metrics = build_retrieval(mtt, "cpu", None)
    coll = mtt.MetricCollection(metrics)
    for a, z in zip(bounds[:-1], bounds[1:]):
        coll.update(cp[a:z], ct[a:z], indexes=ci[a:z])
    if len(coll.compute_groups) != 1:
        raise AssertionError(f"retrieval_path: the CPU collection formed groups {coll.compute_groups}")
    cpu_perq = retrieval_per_query(metrics, ci, cp, ct)
    cpu = _retrieval_values({name: cpu_perq[name].mean() if name in RETRIEVAL_EXACT else m.compute() for name, m in metrics.items()})
    del metrics, coll
    cpu_s = time.perf_counter() - t_cpu

    # exact values per query: bit-equal on the card and the CPU, and in both modes
    for name in RETRIEVAL_EXACT:
        for mode in ("list", "capacity"):
            if not _tree_bit_equal({name: perq[mode][name].cpu()}, {name: cpu_perq[name]}):
                raise AssertionError(f"retrieval_path: {mode} per-query {name} on the card differs from the CPU run")
    for mode, _ in modes:
        _values_close(card[mode], cpu, FLOAT_SUM_RTOL, 1e-6, f"retrieval_path: {mode} mode on the card against the CPU's list mode")
    _values_close(card["capacity"], card["list"], FLOAT_SUM_RTOL, 1e-6, "retrieval_path: the capacity mode against the list mode")
    # the k values (the curve's last 100, the best k) are integers: exact
    for name, ks in (("pr_curve@100", slice(200, None)), ("r@p0.1", slice(1, None))):
        runs = [card["list"][name][ks], card["capacity"][name][ks], cpu[name][ks]]
        if any(r != runs[0] for r in runs):
            raise AssertionError(f"retrieval_path: {name}'s k values differ between the runs: {runs}")
    exact64 = msmarco_float64(idx_np, p_np, t_np, counts)
    for name, want in exact64.items():
        for mode in ("list", "capacity"):
            got = card[mode][name][0]
            if abs(got - want) > FLOAT_SUM_RTOL * abs(want):
                raise AssertionError(f"retrieval_path: {mode} {name} {got} against float64 {want} (rtol {FLOAT_SUM_RTOL})")
    if len(card["list"]["pr_curve@100"]) != 300 or not all(math.isfinite(x) for v in card["list"].values() for x in v):
        raise AssertionError(f"retrieval_path: malformed values {card['list']}")
    emit({
        "phase": "retrieval_path",
        "config": {"queries": MSMARCO_QUERIES, "rows": MSMARCO_ROWS, "depth": MSMARCO_DEPTH, "short_queries": MSMARCO_SHORT_QUERIES,
                   "queries_with_relevant": int((np.bincount(idx_np, weights=t_np, minlength=MSMARCO_QUERIES) > 0).sum()),
                   "relevant_rows": int(t_np.sum()), "relevant_mu": MSMARCO_MU, "query_batch": MSMARCO_QUERY_BATCH,
                   "batches": len(bounds) - 1, "capacity": MSMARCO_CAPACITY, "seed": SEED},
        "modes": report,
        "values": {k: v[0] for k, v in card["list"].items() if len(v) == 1},
        "r@p0.1": card["list"]["r@p0.1"],
        "capacity_values": {k: v[0] for k, v in card["capacity"].items() if len(v) == 1},
        "float64": exact64,
        "capacity_update_blocking_reads": 0,
        "per_query_bit_equal": list(RETRIEVAL_EXACT),
        "cpu_reference_s": cpu_s,
        "phase_s": time.perf_counter() - t_start,
        "kernel_launches": launches,
    })
    return card["list"]


# ----------------------------------------------------------------------
# sliced: the fused ImageNet epoch split into 256 cohorts
# ----------------------------------------------------------------------


def make_slice_ids(rows, batch, num_slices):
    """Seeded slice ids in ``[0, num_slices)``, the last two rows of every
    batch out of range (``num_slices + 7`` and ``-3``), as the JAX
    registry's sliced entry injects them; int32 on the host."""
    import numpy as np

    rng = np.random.default_rng(SEED + 80)
    ids = rng.integers(0, num_slices, rows).astype(np.int32)
    for start in range(0, rows, batch):
        end = min(start + batch, rows)
        ids[end - 2:end] = (num_slices + 7, -3)
    return ids


def build_sliced_eval(pkg, device, num_slices, bap=True):
    """``{acc, prec, rec, f1}`` guarded (``"drop"``), each sliced and padded
    up the ladder, and BinnedAveragePrecision unsliced beside them."""
    kw = dict(num_classes=CLASSES, on_invalid="drop", device=device)

    def sliced(metric):
        return pkg.SlicedMetric(metric, num_slices=num_slices, pad_batches=True)

    members = {
        "acc": sliced(pkg.Accuracy(**kw)),
        "prec": sliced(pkg.Precision(average="macro", **kw)),
        "rec": sliced(pkg.Recall(average="macro", **kw)),
        "f1": sliced(pkg.F1Score(average="macro", **kw)),
    }
    if bap:
        members["bap"] = pkg.BinnedAveragePrecision(thresholds=THRESHOLDS, **kw)
    return pkg.MetricCollection(members)


def run_sliced(coll, preds, target, ids, sync):
    update_s = []
    for start in range(0, preds.shape[0], BATCH):
        sl = slice(start, start + BATCH)
        t0 = time.perf_counter()
        coll.update(preds[sl], target[sl], slice_ids=ids[sl])
        sync()
        update_s.append(time.perf_counter() - t0)
    return update_s


def _unsliced_eval(pkg, device):
    kw = dict(num_classes=CLASSES, on_invalid="drop", device=device)
    return {"acc": pkg.Accuracy(**kw), "prec": pkg.Precision(average="macro", **kw),
            "rec": pkg.Recall(average="macro", **kw), "f1": pkg.F1Score(average="macro", **kw)}


def phase_sliced(dev):
    """The fused evaluation epoch split into ``SLICES`` cohorts on the card:
    the rings against the CPU run, sampled slices against demuxed
    instances, the rollup against the unsliced metrics on the in-range
    rows, the quarantine, discard and pad counts, the faults, K1's
    launches, and the update at K = 1 for comparison."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import histogram as k2

    t_start = time.perf_counter()
    preds, target, nan_rows, label_rows = make_fused_eval_data(dev)
    ids_np = make_slice_ids(ROWS, BATCH, SLICES)
    ids = torch.from_numpy(ids_np).to(dev)
    batches = -(-ROWS // BATCH)
    pad_rows = batches * BATCH - ROWS
    quarantined = 2 * batches

    coll = build_sliced_eval(mtt, dev, SLICES)
    torch.cuda.synchronize()
    k1.reset_launch_count()
    k2.reset_launch_count()
    update_s = run_sliced(coll, preds, target, ids, torch.cuda.synchronize)
    launches = {"binned_counters": k1.launch_count, "histogram": k2.launch_count}
    if launches != {"binned_counters": batches, "histogram": 0}:
        raise AssertionError(f"sliced_path: launches {launches} over {batches} batches")
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        values = coll.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    members = dict(coll.items(keep_base=True, copy_state=False))
    sliced_names = ["acc", "prec", "rec", "f1"]

    # the same stream at K = 1 (without BAP): the update's cost of K
    coll1 = build_sliced_eval(mtt, dev, 1, bap=False)
    update1_s = run_sliced(coll1, preds, target, ids, torch.cuda.synchronize)
    coll_nobap = build_sliced_eval(mtt, dev, SLICES, bap=False)
    update256_s = run_sliced(coll_nobap, preds, target, ids, torch.cuda.synchronize)
    del coll1, coll_nobap

    # counts: the quarantine, the discard (the pad rows), the faults
    want_faults = {"nonfinite_preds": nan_rows, "label_out_of_range": label_rows, "dropped_rows": nan_rows + label_rows,
                   "padded_rows": pad_rows}
    for name in sliced_names:
        m = members[name]
        if m.quarantined_rows != quarantined or m.discarded_rows != pad_rows:
            raise AssertionError(f"sliced_path: {name} quarantined {m.quarantined_rows} (injected {quarantined}), "
                                 f"discarded {m.discarded_rows} (pad rows {pad_rows})")
        got = {k: v for k, v in m.fault_counts.items() if v}
        if got != want_faults:
            raise AssertionError(f"sliced_path: {name} counted faults {got}, injected {want_faults}")
        if int(values[name].quarantined_rows) != quarantined:
            raise AssertionError(f"sliced_path: {name} computed {int(values[name].quarantined_rows)} quarantined rows")

    # the unsliced BAP beside the sliced members: K1's work on this path,
    # against the fused evaluation's CPU run of the same epoch
    want_bap = fused_eval_cpu_reference(preds, target)[0]["bap"]
    got_bap = [float(v) for v in values["bap"]]
    if len(got_bap) != CLASSES or not all(math.isfinite(v) for v in got_bap):
        raise AssertionError(f"sliced_path: bap gave {len(got_bap)} values, not {CLASSES} finite ones")
    bap_err = max(abs(a - b) for a, b in zip(got_bap, want_bap))
    if bap_err > AP_ATOL:
        raise AssertionError(f"sliced_path: bap differs from the CPU run by {bap_err} (atol {AP_ATOL})")
    # a kernel-backed member cannot be sliced on the card (ROADMAP D32): the
    # kernel's wrapper refuses the per-row deltas where it would launch
    for kernel, child in (("K1", mtt.BinnedAveragePrecision(thresholds=THRESHOLDS, num_classes=CLASSES, device=dev)),
                          ("K2", mtt.ConfusionMatrix(num_classes=CLASSES, device=dev))):
        try:
            mtt.SlicedMetric(child, num_slices=SLICES).update(preds[:8], target[:8], slice_ids=ids[:8])
        except ValueError as err:
            if "sliced K1/K2" not in str(err) or not str(err).startswith(kernel):
                raise
        else:
            raise AssertionError(f"sliced_path: a sliced {type(child).__name__} updated on the card")
    if (k1.launch_count, k2.launch_count) != (batches, 0):
        raise AssertionError(f"sliced_path: the refused updates launched ({k1.launch_count}, {k2.launch_count})")

    # the rings against the port's CPU run (integer rings: bit-equal)
    t_cpu = time.perf_counter()
    cpu = build_sliced_eval(mtt, "cpu", SLICES, bap=False)
    run_sliced(cpu, preds.cpu(), target.cpu(), ids.cpu(), lambda: None)
    cpu_s = time.perf_counter() - t_cpu
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    for name in sliced_names:
        a = {k: v.cpu() if isinstance(v, torch.Tensor) else type(v)(*(x.cpu() for x in v)) for k, v in members[name].metric_state.items()}
        if not _tree_bit_equal(a, cpu_members[name].metric_state):
            raise AssertionError(f"sliced_path: {name}'s rings on the card differ from the CPU run")
    cpu_values = cpu.compute()

    # eight sampled slices against demuxed unsliced instances on their own rows
    sampled = [int(k) for k in np.random.default_rng(SEED + 81).choice(SLICES, SLICE_SAMPLES, replace=False)]
    per_slice = {name: values[name].per_slice.cpu() for name in sliced_names}
    for k in sampled:
        rows = torch.from_numpy(np.nonzero(ids_np == k)[0]).to(dev)
        demux = _unsliced_eval(mtt, dev)
        for name, m in demux.items():
            m.update(preds[rows], target[rows])
            rings = members[name].metric_state
            for state, v in m.metric_state.items():
                if not torch.equal(rings[f"sl__{state}"][k], getattr(v, "counts", v)):
                    raise AssertionError(f"sliced_path: slice {k} {name}.{state} differs from a demuxed instance's")
            got, want = float(per_slice[name][k]), float(m.compute())
            if abs(got - want) > 1e-6:
                raise AssertionError(f"sliced_path: slice {k} {name} {got} against a demuxed instance's {want}")
    # the rollup against the unsliced metrics on the in-range rows
    in_range = torch.from_numpy(np.nonzero((ids_np >= 0) & (ids_np < SLICES))[0]).to(dev)
    whole = _unsliced_eval(mtt, dev)
    rollup = {}
    for name, m in whole.items():
        for start in range(0, in_range.shape[0], BATCH):
            rows = in_range[start:start + BATCH]
            m.update(preds[rows], target[rows])
        got, want = float(values[name].global_value), float(m.compute())
        rollup[name] = got
        if abs(got - want) > 1e-6:
            raise AssertionError(f"sliced_path: rollup {name} {got} against the unsliced metric's {want} on the in-range rows")
        if abs(got - float(cpu_values[name].global_value)) > 1e-6:
            raise AssertionError(f"sliced_path: rollup {name} {got} on the card, {float(cpu_values[name].global_value)} on the CPU")
    ring_bytes = {name: sum(t.numel() * t.element_size() for k, v in members[name].metric_state.items() if k.startswith("sl__")
                            for t in [getattr(v, "counts", v)]) for name in sliced_names}
    scrape = members["acc"].scrape_slices()
    emit({
        "phase": "sliced_path",
        "config": {"rows": ROWS, "classes": CLASSES, "batch": BATCH, "slices": SLICES, "fault_share": FAULT_SHARE,
                   "out_of_range_ids_per_batch": 2, "on_invalid": "drop", "pad_batches": True,
                   "members": sliced_names + ["bap (unsliced)"], "seed": SEED},
        "batches": batches,
        "k1_launches": launches["binned_counters"],
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "update_p50_ms_k256_without_bap": statistics.median(update256_s) * 1e3,
        "update_p50_ms_k1_without_bap": statistics.median(update1_s) * 1e3,
        "k256_over_k1": statistics.median(update256_s) / statistics.median(update1_s),
        "compute_s": compute_s,
        "quarantined_rows": quarantined, "discarded_rows": pad_rows, "padded_rows": pad_rows,
        "faults": want_faults,
        "ring_bytes": ring_bytes,
        "rollup": rollup,
        "bap_mean": sum(got_bap) / len(got_bap),
        "bap_max_abs_err_vs_cpu": bap_err,
        "kernel_backed_members_refused": ["K1", "K2"],
        "sampled_slices": sampled,
        "scrape_slices": scrape,
        "cpu_reference_s": cpu_s,
        "phase_s": time.perf_counter() - t_start,
        "rings_equal_cpu_run": True,
    })
    return launches["binned_counters"]


def msmarco_rank_rows(n, rank, world):
    """The rows of ``rank``: ``MSMARCO_WORLD_CHUNK``-row chunks dealt
    round-robin, so a query's candidates can sit on two ranks."""
    import numpy as np

    step = MSMARCO_WORLD_CHUNK
    return np.concatenate([np.arange(s, min(s + step, n)) for s in range(rank * step, n, world * step)])


def retrieval_world(mtt, dist, dev, rank, world, sync):
    """One rank's share of the MS MARCO rows through the world's retrieval
    metrics in both modes, and each synced ``compute()``."""
    import torch

    idx_np, p_np, t_np, _ = make_msmarco()
    take = msmarco_rank_rows(idx_np.shape[0], rank, world)
    idx, preds, target = (torch.from_numpy(x[take]).to(dev) for x in (idx_np, p_np, t_np))
    out = {}
    for mode, cap in (("list", None), ("capacity", MSMARCO_WORLD_CAPACITY)):
        metrics = build_retrieval(mtt, dev, cap, names=MSMARCO_WORLD_METRICS)
        for a in range(0, idx.shape[0], MSMARCO_WORLD_BATCH):
            for m in metrics.values():
                m.update(preds[a:a + MSMARCO_WORLD_BATCH], target[a:a + MSMARCO_WORLD_BATCH], indexes=idx[a:a + MSMARCO_WORLD_BATCH])
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        with CollectiveRecorder() as rec:
            values = {name: m.compute() for name, m in metrics.items()}
            sync()
        out[f"retrieval_{mode}"] = {"values": _retrieval_values(values), "all_reduce": rec.all_reduce, "other": rec.other,
                                    "compute_s": time.perf_counter() - t0, "rows": int(idx.shape[0])}
        del metrics
    return out


def sliced_world(mtt, dist, dev, p, y, ids, sync):
    """One rank's quarter of the sliced evaluation: the overlapped cycle of
    the sliced collection beside the unsliced one's, and the sharded
    slices of a guarded accuracy."""
    group = dist.group.WORLD
    out = {}
    for kind, coll in (("sliced", build_sliced_eval(mtt, dev, SLICES, bap=False)),
                       ("unsliced", mtt.MetricCollection(_unsliced_eval(mtt, dev)))):
        odef = mtt.overlapped_functionalize(coll, group=group)
        state = odef.init()
        for start in range(0, p.shape[0], BATCH):
            kw = {"slice_ids": ids[start:start + BATCH]} if kind == "sliced" else {}
            state = odef.update(state, p[start:start + BATCH], y[start:start + BATCH], **kw)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        with CollectiveRecorder() as rec:
            state = odef.cycle(state)
            sync()
        cycle_s = time.perf_counter() - t0
        with CollectiveRecorder() as rd:
            read = odef.read(state)
            sync()
        fresh = odef.read_fresh(state)
        same = all(_tree_bit_equal(_sliced_value_tree(read[k]), _sliced_value_tree(fresh[k])) for k in read)
        out[f"{kind}_cycle"] = {"all_reduce": rec.all_reduce, "other": rec.other, "cycle_s": cycle_s, "bytes": rec.bytes,
                                "read_collectives": rd.all_reduce + rd.other, "read_bit_equal_fresh": same}
    sdef = mtt.sliced_functionalize(mtt.Accuracy(num_classes=CLASSES, on_invalid="drop", device=dev), SLICES, shard_slices=group)
    state = sdef.init()
    for start in range(0, p.shape[0], BATCH):
        state = sdef.update(state, p[start:start + BATCH], y[start:start + BATCH], slice_ids=ids[start:start + BATCH])
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    with CollectiveRecorder() as rec:
        value = sdef.compute(state)
        sync()
    out["sharded"] = {
        "per_slice": [float(v) for v in value["per_slice"].cpu()], "slice_rows": [int(v) for v in value["slice_rows"].cpu()],
        "slice_offset": int(value["slice_offset"]), "global_value": float(value["global_value"]),
        "quarantined_rows": int(value["quarantined_rows"]), "all_reduce": rec.all_reduce, "other": rec.other,
        "compute_s": time.perf_counter() - t0,
    }
    return out


def _sliced_value_tree(value):
    """A sliced member's value (or a plain one) as a tree of tensors."""
    import torch

    if hasattr(value, "_fields"):
        return {f: torch.as_tensor(v) for f, v in zip(value._fields, value)}
    return {"value": torch.as_tensor(value)}


def check_retrieval_sliced_world(ranks, dev):
    """The world's retrieval and sliced additions against one process on
    the card: the retrieval metrics over the union of the ranks' rows in
    the order the sync gathers them, and the unsharded sliced accuracy."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt

    idx_np, p_np, t_np, _ = make_msmarco()
    union = np.concatenate([msmarco_rank_rows(idx_np.shape[0], r, DIST_WORLD) for r in range(DIST_WORLD)])
    idx, preds, target = (torch.from_numpy(x[union]).to(dev) for x in (idx_np, p_np, t_np))
    report = {}
    for mode, cap in (("list", None), ("capacity", DIST_WORLD * MSMARCO_WORLD_CAPACITY)):
        metrics = build_retrieval(mtt, dev, cap, names=MSMARCO_WORLD_METRICS)
        for a in range(0, idx.shape[0], MSMARCO_WORLD_BATCH):
            for m in metrics.values():
                m.update(preds[a:a + MSMARCO_WORLD_BATCH], target[a:a + MSMARCO_WORLD_BATCH], indexes=idx[a:a + MSMARCO_WORLD_BATCH])
        want = _retrieval_values({name: m.compute() for name, m in metrics.items()})
        del metrics
        key = f"retrieval_{mode}"
        n = len(MSMARCO_WORLD_METRICS)
        want_gathers = ["all_gather"] * (6 if mode == "list" else 12) * n
        want_reduce = [] if mode == "list" else [["int32", "SUM"]] * n
        for r in ranks:
            got = r[key]
            if got["other"] != want_gathers or got["all_reduce"] != want_reduce:
                raise AssertionError(f"retrieval world: rank {r['rank']} {mode} compute made {got['all_reduce']} and {got['other']}; "
                                     f"predicted {want_reduce} and {len(want_gathers)} all_gather")
            if got["values"] != ranks[0][key]["values"]:
                raise AssertionError(f"retrieval world: rank {r['rank']} computed other {mode} values than rank 0")
        _values_close(ranks[0][key]["values"], want, FLOAT_SUM_RTOL, 1e-6, f"retrieval world: {mode} mode against one process")
        report[mode] = {"values": {k: v[0] for k, v in want.items()}, "all_gather_per_compute": len(want_gathers),
                        "all_reduce_per_compute": want_reduce, "compute_s": [r[key]["compute_s"] for r in ranks],
                        "rows_per_rank": [r[key]["rows"] for r in ranks]}

    # the sliced collection's cycle: no more all_reduce than unsliced, and no gather
    for r in ranks:
        s, u = r["sliced_cycle"], r["unsliced_cycle"]
        if s["other"] or u["other"] or len(s["all_reduce"]) > len(u["all_reduce"]) or len(s["all_reduce"]) > 2:
            raise AssertionError(f"sliced world: rank {r['rank']} cycle made {s['all_reduce']} and {s['other']}; unsliced "
                                 f"{u['all_reduce']} and {u['other']}")
        if s["read_collectives"] or not s["read_bit_equal_fresh"] or not u["read_bit_equal_fresh"]:
            raise AssertionError(f"sliced world: rank {r['rank']} read made {s['read_collectives']} or differs from the fresh read")

    # the sharded slices against the unsharded sliced accuracy in one process
    preds_e, target_e, _, _ = make_fused_eval_data(dev)
    ids = torch.from_numpy(make_slice_ids(ROWS, BATCH, SLICES)).to(dev)
    udef = mtt.sliced_functionalize(mtt.Accuracy(num_classes=CLASSES, on_invalid="drop", device=dev), SLICES)
    state = udef.init()
    for start in range(0, ROWS, BATCH):
        state = udef.update(state, preds_e[start:start + BATCH], target_e[start:start + BATCH], slice_ids=ids[start:start + BATCH])
    whole = udef.compute(state)
    per_slice = [float(v) for v in whole.per_slice.cpu()]
    rows = [int(v) for v in state[0]["sl__rows"][:SLICES].cpu()]
    kloc = SLICES // DIST_WORLD
    # JAX: one psum of the rollup tree, one psum_scatter of the rows and of
    # each sum ring (tp, fp, tn, fn and the fault ring)
    want_calls = ([["int64", "SUM"]], ["reduce_scatter"] * 6)
    for r in ranks:
        sh = r["sharded"]
        lo = r["rank"] * kloc
        if sh["slice_offset"] != lo or sh["slice_rows"] != rows[lo:lo + kloc]:
            raise AssertionError(f"sharded slices: rank {r['rank']} owns offset {sh['slice_offset']}, rows {sh['slice_rows'][:4]}...")
        if any(abs(a - b) > 1e-6 for a, b in zip(sh["per_slice"], per_slice[lo:lo + kloc])):
            raise AssertionError(f"sharded slices: rank {r['rank']}'s owned values differ from one process")
        if abs(sh["global_value"] - float(whole.global_value)) > 1e-6 or sh["quarantined_rows"] != int(whole.quarantined_rows):
            raise AssertionError(f"sharded slices: rank {r['rank']} rollup {sh['global_value']}, quarantine {sh['quarantined_rows']}")
        if (sh["all_reduce"], sh["other"]) != want_calls:
            raise AssertionError(f"sharded slices: rank {r['rank']} compute made {sh['all_reduce']} and {sh['other']}; predicted {want_calls}")
    emit({
        "phase": "retrieval_sliced_dist",
        "config": {"world": DIST_WORLD, "retrieval_metrics": list(MSMARCO_WORLD_METRICS), "chunk": MSMARCO_WORLD_CHUNK,
                   "capacity_per_rank": MSMARCO_WORLD_CAPACITY, "slices": SLICES,
                   "backend": "gloo, four processes on one card (loopback TCP; not NCCL)"},
        "retrieval": report,
        "sliced_cycle": {"all_reduce": ranks[0]["sliced_cycle"]["all_reduce"], "unsliced_all_reduce": ranks[0]["unsliced_cycle"]["all_reduce"],
                         "gathers": 0, "cycle_s": [r["sliced_cycle"]["cycle_s"] for r in ranks],
                         "unsliced_cycle_s": [r["unsliced_cycle"]["cycle_s"] for r in ranks],
                         "bytes_per_rank": ranks[0]["sliced_cycle"]["bytes"], "unsliced_bytes_per_rank": ranks[0]["unsliced_cycle"]["bytes"]},
        "sharded": {"all_reduce": ranks[0]["sharded"]["all_reduce"], "other": ranks[0]["sharded"]["other"],
                    "compute_s": [r["sharded"]["compute_s"] for r in ranks], "owned_slices_per_rank": kloc,
                    "global_value": float(whole.global_value), "matches_one_process": True},
    })


# ----------------------------------------------------------------------
# the compiled update (CUDA-graph capture) and serving
# ----------------------------------------------------------------------


def build_compiled(pkg, device):
    """The main path's collection, guarded and padded. BinnedAveragePrecision
    takes no row mask in either package, so it is guarded by ``"warn"``
    (counted, not dropped) and not padded."""
    return pkg.MetricCollection({
        "acc1": pkg.Accuracy(num_classes=CLASSES, on_invalid="drop", pad_batches=True, device=device),
        "acc5": pkg.Accuracy(num_classes=CLASSES, top_k=5, on_invalid="drop", pad_batches=True, device=device),
        "bap": pkg.BinnedAveragePrecision(num_classes=CLASSES, thresholds=THRESHOLDS, on_invalid="warn", device=device),
    })


def _coll_members(coll):
    return dict(coll.items(keep_base=True, copy_state=False))


def eager_twin(coll):
    """``coll`` with every member's update kept eager: ``jittable_update =
    False``, the opt-out the JAX package's runtime uses."""
    for m in _coll_members(coll).values():
        object.__setattr__(m, "jittable_update", False)
    return coll


def _metric_leaves(m):
    from metrics_tpu_torch._capture import _value_leaves

    return [(k, t) for k, v in m._state.items() for t in _value_leaves(v)]


def states_bit_equal(a, b, what):
    import torch

    ma, mb = _coll_members(a), _coll_members(b)
    for name in ma:
        la, lb = _metric_leaves(ma[name]), _metric_leaves(mb[name])
        if len(la) != len(lb):
            raise AssertionError(f"{what}: {name} has {len(la)} state tensors against {len(lb)}")
        for (k, x), (_, y) in zip(la, lb):
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                raise AssertionError(f"{what}: state {name}.{k} differs between the captured and the eager update")


def graph_stats(metrics):
    """Each metric's table of captured graphs, ``{name: metric}``."""
    out = {}
    for name, m in metrics.items():
        t = m.__dict__.get("_update_graphs")
        out[name] = {
            "jittable_update": bool(m.jittable_update),
            "captures": t.captures if t else 0,
            "capture_ms_mean": t.capture_s / t.captures * 1e3 if t and t.captures else None,
            "replays": t.replays if t else 0,
            "eager_updates": t.eager_updates if t else 0,
            "graphs_dropped": t.dropped if t else 0,
            "graphs_held": len(t.entries) if t else 0,
            "capture_error": t.error if t else None,
        }
    return out


def graph_pool_bytes(metrics):
    """Bytes of the card's memory segments in the graph pools of
    ``metrics`` (one pool a metric), from the allocator's snapshot."""
    import torch

    pools = {tuple(m._update_graphs.pool) for m in metrics if m.__dict__.get("_update_graphs") is not None and m._update_graphs.pool is not None}
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        raise AssertionError("the allocator's snapshot names no segment pools")
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) in pools)


class _OneRank:
    """A communicator of a world of one process (a sync that changes
    nothing), so ``sync``/``unsync`` run in this one process."""

    def get_world_size(self, group=None):
        return 1

    def get_rank(self, group=None):
        return 0

    def all_reduce(self, tensor, op=None, group=None):
        pass

    def all_gather(self, parts, tensor, group=None):
        parts[0].copy_(tensor)


def _p(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values) * 1e3, q)) if values else None


def capture_check(make, batches, counter):
    """One kernel's update captured beside its eager twin: the states
    bit-equal after every update, and the launches counted through the
    replays equal to the eager twin's."""
    import torch

    a, e = make(), make()
    object.__setattr__(e, "jittable_update", False)
    launches = {"captured": 0, "eager": 0}
    for i, args in enumerate(batches):
        for name, m in (("captured", a), ("eager", e)):
            before = counter()
            m.update(*args)
            launches[name] += counter() - before
        for (k, x), (_, y) in zip(_metric_leaves(a), _metric_leaves(e)):
            if not torch.equal(x, y):
                raise AssertionError(f"capture check {type(a).__name__}: state {k} differs after update {i}")
    t = a.__dict__.get("_update_graphs")
    out = {"updates": len(batches), "captures": t.captures if t else 0, "replays": t.replays if t else 0,
           "launches": launches, "capture_error": t.error if t else None, "jittable_update": bool(a.jittable_update)}
    if t is not None and t.error is None and launches["captured"] != launches["eager"]:
        raise AssertionError(f"capture check {type(a).__name__}: launches {launches}")
    return out


def phase_compiled(preds, target):
    """The ImageNet epoch twice, captured and eager, in turns; states
    bit-equal after every batch and after reset, load and sync/unsync."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import compactor as k3
    from metrics_tpu_torch.ops import histogram as k2

    dev = preds.device
    n_batches = -(-ROWS // BATCH)
    cap, eag = build_compiled(mtt, dev), eager_twin(build_compiled(mtt, dev))
    times = {name: {"update": [], "forward": []} for name in ("captured", "eager")}
    k1_captured = 0
    for i, start in enumerate(range(0, ROWS, BATCH)):
        p, y = preds[start:start + BATCH], target[start:start + BATCH]
        order = (("captured", cap), ("eager", eag)) if i % 2 == 0 else (("eager", eag), ("captured", cap))
        for name, coll in order:
            before = k1.launch_count
            t0 = time.perf_counter()
            if i % FORWARD_EVERY == 0:
                coll(p, y)
                kind = "forward"
            else:
                coll.update(p, y)
                kind = "update"
            torch.cuda.synchronize()
            times[name][kind].append(time.perf_counter() - t0)
            if name == "captured":
                k1_captured += k1.launch_count - before
        states_bit_equal(cap, eag, f"compiled_path batch {i}")
    bap_updates = _coll_members(cap)["bap"].update_count
    if not (k1_captured == bap_updates == n_batches):
        raise AssertionError(f"compiled_path: K1 counted {k1_captured} launches for {bap_updates} BAP updates over {n_batches} batches")
    epoch_graphs = graph_stats(_coll_members(cap))
    for name, st in epoch_graphs.items():
        if not st["jittable_update"] or st["replays"] == 0 or st["capture_error"]:
            raise AssertionError(f"compiled_path: {name} is not replaying its captured update: {st}")
    vc, ve = cap.compute(), eag.compute()
    for k in ve:
        x, z = (torch.stack(vc[k]), torch.stack(ve[k])) if isinstance(ve[k], list) else (vc[k], ve[k])
        if not torch.equal(x, z):
            raise AssertionError(f"compiled_path: compute() {k} differs between the captured and the eager update")
    pool_bytes = graph_pool_bytes(_coll_members(cap).values())

    # the events that change the states' identity, each followed by updates
    def more(what, offset):
        replays = sum(st["replays"] for st in graph_stats(_coll_members(cap)).values())
        for j in range(W5_BATCHES):
            s0 = (offset + j) * BATCH
            for coll in (cap, eag):
                coll.update(preds[s0:s0 + BATCH], target[s0:s0 + BATCH])
            states_bit_equal(cap, eag, f"compiled_path after {what}, update {j}")
        return sum(st["replays"] for st in graph_stats(_coll_members(cap)).values()) - replays

    events = {}
    for coll in (cap, eag):
        coll.reset()
    events["reset"] = more("reset", 0)
    for coll in (cap, eag):
        coll.persistent(True)
    saved = eag.state_dict()
    more("the saved state", W5_BATCHES)
    for coll in (cap, eag):
        coll.load_state_dict(saved)
    events["load_state_dict"] = more("load_state_dict", 2 * W5_BATCHES)
    for coll in (cap, eag):
        for m in _coll_members(coll).values():
            m.sync(dist_sync_fn=_OneRank(), distributed_available_fn=lambda: True)
            m.unsync()
    events["sync_unsync"] = more("sync and unsync", 3 * W5_BATCHES)
    vc, ve = cap.compute(), eag.compute()
    for k in ve:
        x, z = (torch.stack(vc[k]), torch.stack(ve[k])) if isinstance(ve[k], list) else (vc[k], ve[k])
        if not torch.equal(x, z):
            raise AssertionError(f"compiled_path: compute() {k} differs after the events")
    if min(events.values()) <= 0:
        raise AssertionError(f"compiled_path: no replay after an event: {events}")
    after_events = graph_stats(_coll_members(cap))
    del cap, eag

    # where an update's time goes, captured and eager (after three warm-up
    # updates: eager, capture, replay)
    prof = {
        "captured": profile_updates(build_compiled(mtt, dev), preds, target, BATCH),
        "eager": profile_updates(eager_twin(build_compiled(mtt, dev)), preds, target, BATCH),
    }
    # every batch of the window is a replay: K1's records on the card show
    # that the kernel runs inside the graphs (late in a run the profiler can
    # drop a few records, so the share is reported, not required whole)
    if not prof["captured"]["port_kernel_records_per_batch"]["binned_counters_kernel"] > 0:
        raise AssertionError(f"compiled_path: no record of K1 on the card in a window of replays: {prof['captured']['port_kernel_records_per_batch']}")

    # one update of each kernel captured and held bit-equal over replays
    cm_batches = [(preds[i * BATCH:(i + 1) * BATCH], target[i * BATCH:(i + 1) * BATCH]) for i in range(CAPTURE_UPDATES)]
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    q_batches = [(torch.empty(STREAM_BATCH, device=dev).log_normal_(0.0, 1.0, generator=g),) for _ in range(CAPTURE_UPDATES)]
    kernel_checks = {
        "histogram": capture_check(lambda: mtt.ConfusionMatrix(CLASSES, on_invalid="warn", device=dev), cm_batches, lambda: k2.launch_count),
        "compactor_fold": capture_check(lambda: mtt.QuantileSketch(eps=0.01, device=dev), q_batches, lambda: k3.launch_count),
    }
    if kernel_checks["histogram"]["replays"] != CAPTURE_UPDATES - 1:
        raise AssertionError(f"compiled_path: the guarded ConfusionMatrix did not replay: {kernel_checks['histogram']}")
    del q_batches

    def side(name):
        t = times[name]
        return {
            "update_p50_ms": _p(t["update"], 50),
            "update_p99_ms": _p(t["update"], 99),
            "forward_p50_ms": _p(t["forward"], 50),
            "first_update_ms": t["update"][0] * 1e3,
            "rows_per_s": ROWS / (sum(t["update"]) + sum(t["forward"])),
            "device_ops_per_batch": prof[name]["device_ops_per_batch"],
            "blocking_reads_per_batch": prof[name]["stream_syncs_per_batch"],
            "device_idle_share": prof[name]["device_idle_share"],
            "profile": prof[name],
        }

    emit({
        "phase": "compiled_path",
        "config": {"rows": ROWS, "classes": CLASSES, "thresholds": THRESHOLDS, "batch": BATCH, "seed": SEED, "forward_every": FORWARD_EVERY,
                   "members": {"acc1": "Accuracy, drop, padded", "acc5": "Accuracy(top_k=5), drop, padded", "bap": "BinnedAveragePrecision(100), warn, unpadded"}},
        "batches": n_batches,
        "captured": side("captured"),
        "eager": side("eager"),
        "update_p50_eager_over_captured": _p(times["eager"]["update"], 50) / _p(times["captured"]["update"], 50),
        "graphs_after_epoch": epoch_graphs,
        "graphs_after_events": after_events,
        "replays_after_event": events,
        "k1_launches_through_replays": k1_captured,
        "bap_updates": bap_updates,
        "graph_pool_bytes": pool_bytes,
        "kernel_captures": kernel_checks,
        "states_bit_equal_after_every_batch": True,
    })
    return k1_captured, kernel_checks


def serve_plan(rows, seed):
    """Ragged requests over ``rows``: a tier drawn uniformly, then a size
    uniformly within it; ``[(start, size), ...]``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    plan, off = [], 0
    while off < rows:
        lo, hi = SERVE_SPANS[SERVE_LADDER[int(rng.integers(0, len(SERVE_LADDER)))]]
        n = min(int(rng.integers(lo, hi + 1)), rows - off)
        plan.append((off, n))
        off += n
    return plan


def _serving_proto(mtt, dev):
    """The served collection. BAP cannot pad (no row mask), so ragged
    requests would capture a graph for every size: it is served eager."""
    proto = build_compiled(mtt, dev)
    object.__setattr__(_coll_members(proto)["bap"], "jittable_update", False)
    return proto


def _replica_captures(loop):
    return sum(st["captures"] for r in loop._replicas for st in graph_stats(_coll_members(r)).values())


def phase_with_ladder(ladder, fn, *args):
    """``fn(*args)`` with ``METRICS_TPU_PAD_LADDER`` set to ``ladder``."""
    import os

    from metrics_tpu_torch.ops import padding

    old = os.environ.get("METRICS_TPU_PAD_LADDER")
    os.environ["METRICS_TPU_PAD_LADDER"] = ",".join(str(t) for t in ladder)
    padding.reset_padding_state()
    try:
        return fn(*args)
    finally:
        if old is None:
            os.environ.pop("METRICS_TPU_PAD_LADDER", None)
        else:
            os.environ["METRICS_TPU_PAD_LADDER"] = old
        padding.reset_padding_state()


# serving_path's request p50/p99 (ms), printed beside serving_obs_path's
_SERVING_LATENCY = {}


def phase_serving(preds, target):
    """The served ImageNet evaluation: the epoch's rows as ragged requests
    into ``ServeLoop(workers=4, warmup=...)``."""
    import threading

    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import padding

    dev = preds.device
    plan = serve_plan(ROWS, SEED + 11)
    example = (preds[:BATCH].cpu().numpy(), target[:BATCH].cpu().numpy())
    k1.reset_launch_count()
    t0 = time.perf_counter()
    loop = mtt.ServeLoop(_serving_proto(mtt, dev), workers=SERVE_WORKERS, queue_size=len(plan) + 1, warmup=mtt.Warmup(example))
    latencies = []
    timed_updates(loop, latencies, threading.Lock())
    if not loop.wait_warmup(300):
        raise AssertionError("serving_path: the warmup did not end")
    warm = loop.health()["serving"]["warmup"]
    warm_total_s = time.perf_counter() - t0
    captured_at_warmup = _replica_captures(loop)
    expected_graphs = SERVE_WORKERS * 2 * len(SERVE_LADDER)
    if warm["status"] != "done" or warm["graphs_captured"] != expected_graphs or captured_at_warmup != expected_graphs:
        raise AssertionError(f"serving_path: warmup {warm}, {captured_at_warmup} graphs held, expected {expected_graphs}")
    accepted = []
    t1 = time.perf_counter()
    for off, n in plan:
        if loop.offer(preds[off:off + n], target[off:off + n]):
            accepted.append((off, n))
    if not loop.drain(300):
        raise AssertionError("serving_path: the loop did not drain")
    serve_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    loop.report()
    stale_ms = (time.perf_counter() - t2) * 1e3
    t3 = time.perf_counter()
    view = loop.report(fresh=True, deadline_s=120)
    fresh_ms = (time.perf_counter() - t3) * 1e3
    loop.stop()
    stats = view["stats"]
    if not view["fresh"] or stats["accepted"] + stats["shed"] != stats["offered"] or stats["failed"] or stats["processed"] != stats["accepted"]:
        raise AssertionError(f"serving_path: report {view['fresh']}, stats {stats}")
    request_captures = _replica_captures(loop) - captured_at_warmup
    if request_captures:
        raise AssertionError(f"serving_path: {request_captures} captures on the request path after wait_warmup()")
    bap_updates = sum(_coll_members(r)["bap"].update_count for r in loop._replicas)
    k1_serving = k1.launch_count
    if not (k1_serving == bap_updates == len(accepted)):
        raise AssertionError(f"serving_path: K1 {k1_serving} launches, {bap_updates} BAP updates, {len(accepted)} accepted requests")
    replays = sum(st["replays"] for r in loop._replicas for st in graph_stats(_coll_members(r)).values())
    # one eager collection over the accepted requests, as they were sized
    ref = eager_twin(build_compiled(mtt, dev))
    for off, n in accepted:
        ref.update(preds[off:off + n], target[off:off + n])
    states_bit_equal(loop._last_reporter, ref, "serving_path: the merged view against one eager collection")
    want = ref.compute()
    for k in want:
        x, z = (torch.stack(view["value"][k]), torch.stack(want[k])) if isinstance(want[k], list) else (view["value"][k], want[k])
        if not torch.equal(x, z):
            raise AssertionError(f"serving_path: reported {k} differs from the eager collection over the accepted rows")
    by_tier = {}
    for n, dt in latencies:
        by_tier.setdefault(padding.tier_for(n), []).append(dt)
    _SERVING_LATENCY.update(p50=_p([dt for _, dt in latencies], 50), p99=_p([dt for _, dt in latencies], 99))
    emit({
        "phase": "serving_path",
        "config": {"rows": ROWS, "classes": CLASSES, "workers": SERVE_WORKERS, "ladder": list(SERVE_LADDER),
                   "requests": len(plan), "seed": SEED + 11, "bap": "served eager: it takes no row mask, so it cannot pad"},
        "stats": stats,
        "rows_per_s": sum(n for _, n in accepted) / serve_s,
        "request_update_ms_by_tier": {str(t): {"p50": _p(v, 50), "p99": _p(v, 99), "requests": len(v)} for t, v in sorted(by_tier.items())},
        "report_stale_ms": stale_ms,
        "report_fresh_ms": fresh_ms,
        "warmup": warm,
        "warmup_and_start_s": warm_total_s,
        "graphs_captured": captured_at_warmup,
        "graphs_expected": f"{SERVE_WORKERS} replicas x 2 padded members x {len(SERVE_LADDER)} tiers = {expected_graphs}",
        "captures_on_request_path": request_captures,
        "replays": replays,
        "k1_launches": k1_serving,
        "bap_updates": bap_updates,
        "values_equal_eager_over_accepted_rows": True,
    })
    return k1_serving


def timed_updates(loop, out, lock):
    """Wrap each replica's ``update`` to append ``(rows, seconds)`` to
    ``out``: the update and a synchronize of the worker's stream."""
    import torch

    for replica in loop._replicas:
        def timed(*args, _update=replica.update, **kwargs):
            t = time.perf_counter()
            _update(*args, **kwargs)
            torch.cuda.current_stream().synchronize()
            with lock:
                out.append((args[0].shape[0], time.perf_counter() - t))
        replica.update = timed


def phase_coldstart(preds, target):
    """The first request at each tier on fresh loops, with and without
    warmup, timed on the worker (the update and a synchronize)."""
    import threading

    import torch

    import metrics_tpu_torch as mtt

    dev = preds.device
    example = (preds[:BATCH].cpu().numpy(), target[:BATCH].cpu().numpy())
    first = {"cold": {t: [] for t in SERVE_LADDER}, "warm": {t: [] for t in SERVE_LADDER}}
    warm_wall = []
    for kind in ("cold", "warm", "cold", "warm") * ((COLDSTART_LOOPS + 1) // 2):
        if len(first[kind][SERVE_LADDER[0]]) >= COLDSTART_LOOPS:
            continue
        spec = mtt.Warmup(example) if kind == "warm" else None
        loop = mtt.ServeLoop(_serving_proto(mtt, dev), workers=1, warmup=spec)
        latencies = []
        timed_updates(loop, latencies, threading.Lock())
        try:
            if spec is not None:
                if not loop.wait_warmup(300) or loop.health()["serving"]["warmup"]["status"] != "done":
                    raise AssertionError(f"coldstart_path: warmup {loop.health()['serving']['warmup']}")
                warm_wall.append(loop.health()["serving"]["warmup"]["wall_s"])
            for tier in sorted(SERVE_LADDER, reverse=True):
                torch.cuda.synchronize()
                loop.offer(preds[:tier], target[:tier])
                if not loop.drain(120):
                    raise AssertionError("coldstart_path: a first request did not finish")
            captures = _replica_captures(loop)
        finally:
            loop.stop()
        for n, dt in latencies:
            first[kind][n].append(dt)
        if kind == "warm" and captures != 2 * len(SERVE_LADDER):
            raise AssertionError(f"coldstart_path: a warmed loop holds {captures} graphs")
    emit({
        "phase": "coldstart_path",
        "config": {"loops": COLDSTART_LOOPS, "workers": 1, "ladder": list(SERVE_LADDER), "order": "largest tier first",
                   "timed": "on the worker: the update and a synchronize of its stream"},
        "first_request_ms": {kind: {str(t): {"p50": _p(v, 50), "p99": _p(v, 99)} for t, v in tiers.items()} for kind, tiers in first.items()},
        "warmup_wall_s_p50": statistics.median(warm_wall),
        "warmup_wall_s": warm_wall,
    })


# -- the image slice (phases 26-28) ------------------------------------------


def _kernel_counts():
    from metrics_tpu_torch.ops import binned_counters, compactor, histogram

    return {"binned_counters": binned_counters.launch_count, "histogram": histogram.launch_count,
            "compactor_fold": compactor.launch_count, "compactor_fold_single": compactor.fold_launch_count}


def _reset_kernel_counts():
    from metrics_tpu_torch.ops import binned_counters, compactor, histogram

    for kernel in (binned_counters, compactor, histogram):
        kernel.reset_launch_count()


def _check_no_kernel_launched(phase):
    """The image path launches none of K1-K3: their counts, set to 0 just
    before the phase, read 0 after it."""
    counts = _kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"{phase}: the image path launched {counts}")
    return counts


def _close_or_fail(card, cpu, rtol, atol, what):
    """``card`` within ``rtol``/``atol`` of ``cpu`` (and finite); returns the
    largest absolute difference."""
    import torch

    card, cpu = card.detach().double().cpu(), cpu.detach().double()
    if card.shape != cpu.shape or not bool(torch.isfinite(card).all()) or not torch.allclose(card, cpu, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: the card's {card.flatten()[:4].tolist()} against the CPU's {cpu.flatten()[:4].tolist()} (rtol={rtol}, atol={atol})")
    return float((card - cpu).abs().max())


def _feature_err(card, cpu):
    """A net's outputs on the card against the CPU run: the largest absolute
    difference, the largest relative one where the CPU's value is at least
    0.05, and whether every element is within FEATURE_RTOL/FEATURE_ATOL."""
    import torch

    card, cpu = card.detach().double().cpu(), cpu.detach().double()
    diff = (card - cpu).abs()
    big = cpu.abs() >= 0.05
    return {"max_abs_err": float(diff.max()), "max_rel_err_where_at_least_0.05": float((diff[big] / cpu.abs()[big]).max()) if bool(big.any()) else None,
            "within": bool(torch.isfinite(card).all()) and bool(torch.allclose(card, cpu, rtol=FEATURE_RTOL, atol=FEATURE_ATOL))}


def _timed_p50_ms(fn, iters):
    """p50 of ``fn`` in ms, each call between two synchronizes, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return _p(times, 50)


def _separable_banded(x, factors):
    """The JAX package's form of the separable window, for the timing: each
    pass a product with the banded matrix ``B[i, j] = f[i - j]`` over its
    axis (its convolution past 2048 pixels is not needed at 512)."""
    import torch

    out = x
    for dim, f in enumerate(factors):
        axis = 2 + dim
        k, size_in = f.shape[-1], out.shape[axis]
        d = torch.arange(size_in, device=f.device)[:, None] - torch.arange(size_in - k + 1, device=f.device)[None, :]
        band = torch.where((d >= 0) & (d < k), f[d.clamp(0, k - 1)], torch.zeros((), dtype=f.dtype, device=f.device))
        out = torch.matmul(out.movedim(axis, -1), band).movedim(-1, axis)
    return out


def phase_image_functional(dev):
    """Every functional image metric on one seeded batch on the card
    against the port's CPU run, and SSIM p50 at 2x3x512x512 in both forms
    of the separable window."""
    import torch

    import metrics_tpu_torch.functional.image as tf
    from metrics_tpu_torch.functional.image import ssim as ssim_module
    from metrics_tpu_torch.utilities.compute import full_float32

    t_phase = time.perf_counter()
    _reset_kernel_counts()
    g = torch.Generator().manual_seed(SEED + 12)
    rgb = torch.rand(IMG_FUNCTIONAL_RGB, generator=g)
    rgb_t = (rgb + 0.05 * torch.randn(IMG_FUNCTIONAL_RGB, generator=g)).clamp(0, 1)
    ms = torch.rand(IMG_FUNCTIONAL_MS, generator=g) + 0.1
    ms_t = (ms * (1 + 0.05 * torch.randn(IMG_FUNCTIONAL_MS, generator=g))).clamp(min=0.01)
    cases = {
        "psnr": (tf.peak_signal_noise_ratio, rgb, rgb_t, {"data_range": 1.0}),
        "psnr_dim": (tf.peak_signal_noise_ratio, rgb, rgb_t, {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}),
        "ssim": (tf.structural_similarity_index_measure, rgb, rgb_t, {"data_range": 1.0, "reduction": "none"}),
        "ssim_box": (tf.structural_similarity_index_measure, rgb, rgb_t, {"data_range": 1.0, "gaussian_kernel": False}),
        "ms_ssim": (tf.multiscale_structural_similarity_index_measure, rgb, rgb_t, {"data_range": 1.0, "reduction": "none"}),
        "uqi": (tf.universal_image_quality_index, rgb, rgb_t, {}),
        "ergas": (tf.error_relative_global_dimensionless_synthesis, ms, ms_t, {"reduction": "none"}),
        "sam": (tf.spectral_angle_mapper, ms, ms_t, {}),
        "d_lambda": (tf.spectral_distortion_index, ms, ms_t, {}),
    }
    out = {}
    for name, (fn, p, t, kw) in cases.items():
        cpu = fn(p, t, **kw)
        pd, td = p.to(dev), t.to(dev)
        card = fn(pd, td, **kw)
        out[name] = {"max_abs_err": _close_or_fail(card, cpu, IMG_RTOL, IMG_ATOL, f"image_functional_path {name}"),
                     "value": float(card.float().mean())}
        out[name]["ms_p50"] = _timed_p50_ms(lambda: fn(pd, td, **kw), 10)
    for i, (card, cpu) in enumerate(zip(tf.image_gradients(rgb.to(dev)), tf.image_gradients(rgb))):
        out[("dy", "dx")[i]] = {"max_abs_err": _close_or_fail(card, cpu, 0.0, 0.0, "image_gradients")}
    # the window's two forms at bench.py's SSIM shape, in turns
    g512 = torch.Generator(device=dev).manual_seed(SEED + 13)
    p512 = torch.rand(SSIM_BENCH_SHAPE, generator=g512, device=dev)
    t512 = (p512 + 0.05 * torch.randn(SSIM_BENCH_SHAPE, generator=g512, device=dev)).clamp(0, 1)
    def banded(x, factors):
        with full_float32(x.is_cuda):
            return _separable_banded(x, factors)

    path_window = ssim_module._depthwise_conv_separable
    forms, values = {}, {}
    try:
        for form in ("conv", "banded", "banded", "conv"):
            # JAX's banded product put in the place of the path's convolution
            ssim_module._depthwise_conv_separable = banded if form == "banded" else path_window
            forms.setdefault(form, []).append(_timed_p50_ms(lambda: tf.structural_similarity_index_measure(p512, t512, data_range=1.0), SSIM_BENCH_ITERS))
            values[form] = tf.structural_similarity_index_measure(p512, t512, data_range=1.0)
    finally:
        ssim_module._depthwise_conv_separable = path_window
    form_err = _close_or_fail(values["banded"], values["conv"], IMG_RTOL, IMG_ATOL, "the two window forms")
    emit({
        "phase": "image_functional_path",
        "nvidia_smi": nvidia_smi_line(),
        "shapes": {"rgb": list(IMG_FUNCTIONAL_RGB), "multispectral": list(IMG_FUNCTIONAL_MS)},
        "tolerance": {"rtol": IMG_RTOL, "atol": IMG_ATOL, "gradients": "exact"},
        "against_cpu": out,
        "ssim_512": {"shape": list(SSIM_BENCH_SHAPE), "p50_ms_by_form": forms, "path_form": "conv",
                     "forms_max_abs_err": form_err, "value": float(values["conv"])},
        "kernel_launches": _check_no_kernel_launched("image_functional_path"),
        "seconds": time.perf_counter() - t_phase,
    })


def image_pair_batch(index, n, dev):
    """``n`` seeded 3x256x256 uint8 pairs, made on the card: a real image is
    a random 16x16 field upsampled (bicubic) to 256 plus pixel noise; its
    generated twin is the real image shifted two pixels to the right,
    brightened by 4 and given noise of its own."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED * 1_000_003 + index)
    field = F.interpolate(torch.rand((n, 3, 16, 16), generator=g, device=dev), size=(IMG_SIZE, IMG_SIZE), mode="bicubic", align_corners=False)
    real = (field * 255 + 8 * torch.randn((n, 3, IMG_SIZE, IMG_SIZE), generator=g, device=dev)).clamp(0, 255).round()
    fake = (real.roll(2, dims=3) + 4 + 6 * torch.randn((n, 3, IMG_SIZE, IMG_SIZE), generator=g, device=dev)).clamp(0, 255).round()
    return real.to(torch.uint8), fake.to(torch.uint8)


@contextlib.contextmanager
def _tf32_allowed(on):
    """TF32 in cuDNN and in the products inside the block when ``on``; the
    previous settings after it."""
    import torch

    if not on:
        yield
        return
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic, allow_tf32=True):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul


def _quiet(make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make()


def _float64_kid(real, fake, subsets, subset_size, seed):
    """KID in float64 on the card, on the subsets that
    ``np.random.seed(seed)`` draws, in the metric's order (numpy draws the
    subsets, as the metric does; the float64 products run on the card:
    the host took 20 s for them)."""
    import numpy as np
    import torch

    np.random.seed(seed)
    real, fake = real.double(), fake.double()
    gamma = 1.0 / real.shape[1]
    m = subset_size
    scores = []
    for _ in range(subsets):
        x = real[torch.from_numpy(np.random.permutation(real.shape[0])[:m]).to(real.device)]
        y = fake[torch.from_numpy(np.random.permutation(fake.shape[0])[:m]).to(fake.device)]
        kxx, kyy, kxy = ((a @ b.T * gamma + 1.0) ** 3 for a, b in ((x, x), (y, y), (x, y)))
        scores.append((kxx.sum() - kxx.trace() + kyy.sum() - kyy.trace()) / (m * (m - 1)) - 2 * kxy.sum() / m**2)
    scores = torch.stack(scores)
    return float(scores.mean()), float(scores.std())


def _numpy_is(logits, splits, seed):
    import numpy as np

    np.random.seed(seed)
    x = logits[np.random.permutation(logits.shape[0])].astype(np.float64)
    x = x - x.max(axis=1, keepdims=True)
    log_p = x - np.log(np.exp(x).sum(axis=1, keepdims=True))
    p = np.exp(log_p)
    kl = []
    for pc, lpc in zip(np.array_split(p, splits), np.array_split(log_p, splits)):
        kl.append(np.exp((pc * (lpc - np.log(pc.mean(axis=0, keepdims=True)))).sum(axis=1).mean()))
    kl = np.asarray(kl)
    return kl.mean(), kl.std(ddof=1)


def _scipy_fid(real, fake):
    """FID in float64: the means and covariances on the card, ``sqrtm`` on
    the host by scipy."""
    import numpy as np
    import scipy.linalg
    import torch

    stats = []
    for f in (real, fake):
        f = f.double()
        mu = f.mean(0)
        c = f - mu
        stats.append((mu, c.T @ c / (f.shape[0] - 1)))
    (mu1, s1), (mu2, s2) = stats
    s1, s2 = s1.cpu().numpy(), s2.cpu().numpy()
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    return float(((mu1 - mu2) ** 2).sum().item() + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean).real)


def phase_fid50k(dev):
    """The FID-50K protocol of class-conditional ImageNet 256x256
    generation, cut to FID-10K (``FID_IMAGES``): real and generated uint8
    images through one
    seeded InceptionV3 (fid variant, resize 256 -> 299) in batches of 250,
    into FID and KID (list mode, 2048 features), IS (the generated images'
    logits, 10 splits) and FID with ``capacity=65536`` (captured update)."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.functional.image.fid import frechet_inception_distance_from_features as fid_from_features
    from metrics_tpu_torch.nets import InceptionV3Extractor

    t_phase = time.perf_counter()
    _reset_kernel_counts()
    extractor = _quiet(lambda: InceptionV3Extractor(2048, variant="fid", seed=SEED, device=dev))
    fid = mtt.FrechetInceptionDistance(feature=2048, device=dev)
    kid = mtt.KernelInceptionDistance(feature=2048, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, device=dev)
    inception = mtt.InceptionScore(feature=1008, splits=IS_SPLITS, device=dev)
    ring = mtt.FrechetInceptionDistance(feature=2048, capacity=FID_CAPACITY, device=dev)
    batches = FID_IMAGES // FID_BATCH
    host_real, host_fake, host_logits = [], [], []
    extract_ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold counts in the peak: reported apart
    held_before = torch.cuda.memory_allocated()
    t_loop = time.perf_counter()
    with torch.no_grad():
        for i in range(batches):
            real, fake = image_pair_batch(i, FID_BATCH, dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            tr = extractor.taps(real, (2048,))
            tg = extractor.taps(fake, (2048,))
            end.record()
            extract_ms.append((start, end))
            fid.update(tr[2048], real=True)
            fid.update(tg[2048], real=False)
            kid.update(tr[2048], real=True)
            kid.update(tg[2048], real=False)
            inception.update(tg["logits"])
            ring.update(tr[2048], real=True)
            ring.update(tg[2048], real=False)
            host_real.append(tr[2048].cpu())
            host_fake.append(tg[2048].cpu())
            host_logits.append(tg["logits"].cpu())
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    peak = torch.cuda.max_memory_allocated()
    extract_s = sum(s.elapsed_time(e) for s, e in extract_ms) / 1e3
    real_f, fake_f, logits = torch.cat(host_real), torch.cat(host_fake), torch.cat(host_logits)
    table = ring.__dict__.get("_update_graphs")
    graphs = {"captures": table.captures if table else 0, "replays": table.replays if table else 0,
              "eager_updates": table.eager_updates if table else 0, "capture_error": table.error if table else None,
              "jittable_update": bool(ring.jittable_update)}
    want = {"captures": 2, "replays": 2 * batches - 2, "eager_updates": 2, "capture_error": None, "jittable_update": True}
    if graphs != want:
        raise AssertionError(f"fid50k_path: the capacity update's graphs {graphs}, expected {want}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0

    fid_value, fid_s = timed(lambda: float(fid.compute()))
    ring_value, ring_s = timed(lambda: float(ring.compute()))
    np.random.seed(SEED + 1)
    (kid_mean, kid_std), kid_s = timed(lambda: tuple(float(v) for v in kid.compute()))
    np.random.seed(SEED + 2)
    (is_mean, is_std), is_s = timed(lambda: tuple(float(v) for v in inception.compute()))
    # the real set against itself
    self_fid = mtt.FrechetInceptionDistance(feature=2048, device=dev)
    self_fid.update(real_f.to(dev), real=True)
    self_fid.update(real_f.to(dev), real=False)
    self_value = float(self_fid.compute())
    self_trace = float(real_f.to(dev).var(dim=0).sum())
    self_value64 = float(fid_from_features(real_f.to(dev).double(), real_f.to(dev).double()))
    # the float64 references, on the card's own features
    t_ref = time.perf_counter()
    scipy_fid = _scipy_fid(real_f.to(dev), fake_f.to(dev))
    kid_ref = _float64_kid(real_f.to(dev), fake_f.to(dev), kid.subsets, kid.subset_size, SEED + 1)
    is_ref = _numpy_is(logits.numpy(), IS_SPLITS, SEED + 2)
    ref_s = time.perf_counter() - t_ref
    checks = {
        # float32 on the card, where the trace terms cancel to the FID
        "fid_vs_scipy_err": abs(fid_value - scipy_fid),
        "capacity_vs_list_err": abs(ring_value - fid_value),
        # held to the traces that cancel in it (float32 Newton-Schulz)
        "self_fid_over_traces": abs(self_value) / (2 * self_trace),
        "self_fid_float64": abs(self_value64),
        # KID: float32 sums of 10^6 kernel values a subset, against float64
        "kid_mean_err": abs(kid_mean - kid_ref[0]),
        "kid_std_err": abs(kid_std - kid_ref[1]),
        "is_mean_rel": abs(is_mean - is_ref[0]) / abs(is_ref[0]),
        # the std of ten float32 exponentials: held to the scale of the mean
        "is_std_err_over_mean": abs(is_std - is_ref[1]) / abs(is_ref[0]),
    }
    limits = {"fid_vs_scipy_err": FID_ATOL + FID_RTOL * abs(scipy_fid), "capacity_vs_list_err": FID_ATOL + FID_RTOL * abs(fid_value),
              "self_fid_over_traces": FID_SELF_RTOL, "self_fid_float64": FID_SELF_ATOL,
              "kid_mean_err": KID_ATOL + KID_IS_RTOL * abs(kid_ref[0]), "kid_std_err": KID_ATOL + KID_IS_RTOL * abs(kid_ref[1]),
              "is_mean_rel": KID_IS_RTOL, "is_std_err_over_mean": KID_IS_RTOL}
    failures = [f"{k} = {v}, over {limits[k]}" for k, v in checks.items() if not abs(v) <= limits[k]]
    # features of the first images of each set against the port's CPU run
    t_cpu = time.perf_counter()
    cpu_extractor = _quiet(lambda: InceptionV3Extractor(2048, variant="fid", seed=SEED, device="cpu"))
    feature_err = {}
    with torch.no_grad():
        real0, fake0 = image_pair_batch(0, FID_BATCH, dev)
        for name, imgs, card in (("real", real0, real_f), ("fake", fake0, fake_f)):
            cpu = cpu_extractor.taps(imgs[:FID_CPU_IMAGES].cpu(), (2048,))
            feature_err[name] = _feature_err(card[:FID_CPU_IMAGES], cpu[2048])
            if name == "fake":
                feature_err["logits"] = _feature_err(logits[:FID_CPU_IMAGES], cpu["logits"])
    failures += [f"{k} features against the CPU: {v}" for k, v in feature_err.items() if not v["within"]]
    cpu_s = time.perf_counter() - t_cpu
    # TF32 once beside float32, on the same batches and weights: the
    # extractor's net called without the extractor's float32 block, with
    # TF32 on around those calls only (this script turns it off for the
    # process)
    def tf32_features(imgs):
        return extractor.module(extractor.preprocess(imgs), features=(2048,))[2048]

    tf32_ms, fp32_ms, drift = [], [], 0.0
    with torch.no_grad():
        for i in range(TF32_BATCHES):
            real, _ = image_pair_batch(i, FID_BATCH, dev)
            for name, fn, sink in (("fp32", extractor, fp32_ms), ("tf32", tf32_features, tf32_ms)):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                with _tf32_allowed(name == "tf32"):
                    start.record()
                    feats = fn(real)
                    end.record()
                end.synchronize()
                sink.append(start.elapsed_time(end))
                if name == "tf32":
                    drift = max(drift, float((feats - real_f[i * FID_BATCH:(i + 1) * FID_BATCH].to(dev)).abs().max()))
    emit({
        "phase": "fid50k_path",
        "nvidia_smi": nvidia_smi_line(),
        "config": {"images_per_side": FID_IMAGES, "size": IMG_SIZE, "batch": FID_BATCH, "net": "InceptionV3 fid variant, seeded random weights (uncalibrated)",
                   "resize": "256 -> 299 bilinear", "kid": {"subsets": kid.subsets, "subset_size": kid.subset_size}, "is_splits": IS_SPLITS,
                   "capacity": FID_CAPACITY},
        "values": {"fid": fid_value, "fid_capacity": ring_value, "fid_scipy_float64": scipy_fid, "self_fid": self_value,
                   "self_fid_float64": self_value64,
                   "kid": [kid_mean, kid_std], "kid_float64": list(kid_ref), "is": [is_mean, is_std], "is_float64": list(is_ref),
                   "fid_rung": fid.ladder_rung, "fid_capacity_rung": ring.ladder_rung, "self_fid_rung": self_fid.ladder_rung},
        "checks": checks, "limits": limits, "fid_vs_scipy_rel": abs(fid_value - scipy_fid) / abs(scipy_fid),
        "features_against_cpu": {"images": FID_CPU_IMAGES, "rtol": FEATURE_RTOL, "atol": FEATURE_ATOL,
                                 **feature_err},
        "extractor": {"images": 2 * FID_IMAGES, "float32_images_per_s": 2 * FID_IMAGES / extract_s, "float32_s": extract_s,
                      "tf32_images_per_s": TF32_BATCHES * FID_BATCH / (sum(tf32_ms) / 1e3),
                      "float32_images_per_s_same_batches": TF32_BATCHES * FID_BATCH / (sum(fp32_ms) / 1e3),
                      "tf32_max_abs_feature_drift": drift, "peak_memory_bytes": peak,
                      "held_before_loop_bytes": held_before, "peak_over_held_bytes": peak - held_before},
        "compute_s": {"fid": fid_s, "fid_capacity": ring_s, "kid": kid_s, "is": is_s},
        "capacity_graphs": graphs,
        "loop_s": loop_s, "host_references_s": ref_s, "cpu_features_s": cpu_s,
        "kernel_launches": _check_no_kernel_launched("fid50k_path"),
        "failures": failures,
        "seconds": time.perf_counter() - t_phase,
    })
    if failures:
        raise AssertionError(f"fid50k_path: {failures}")


def phase_lpips_ssim(dev):
    """The 50,000 real/generated pairs through LPIPS (AlexNet), streaming
    SSIM, streaming MS-SSIM and PSNR; each held against the port's CPU run
    on the first 64 pairs, the streamed SSIM against the accumulate mode
    over the first 1024 pairs."""
    import torch

    import metrics_tpu_torch as mtt

    t_phase = time.perf_counter()
    _reset_kernel_counts()

    def build(device):
        return {
            "lpips": _quiet(lambda: mtt.LearnedPerceptualImagePatchSimilarity(net_type="alex", device=device)),
            "ssim": mtt.StructuralSimilarityIndexMeasure(data_range=1.0, streaming=True, device=device),
            "ms_ssim": mtt.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, streaming=True, device=device),
            "psnr": mtt.PeakSignalNoiseRatio(data_range=1.0, device=device),
        }

    def inputs(name, real, fake):
        if name == "lpips":
            return real.float() / 127.5 - 1.0, fake.float() / 127.5 - 1.0
        return real.float() / 255.0, fake.float() / 255.0

    # the first PAIR_CPU pairs, on the card and on the CPU
    real0, fake0 = image_pair_batch(0, PAIR_CPU, dev)
    card_m, cpu_m = build(dev), build("cpu")
    against_cpu = {}
    t_cpu = time.perf_counter()
    with torch.no_grad():
        for name in card_m:
            card_m[name].update(*inputs(name, real0, fake0))
            cpu_m[name].update(*inputs(name, real0.cpu(), fake0.cpu()))
            err = _close_or_fail(card_m[name].compute(), cpu_m[name].compute(), IMG_RTOL, IMG_ATOL, f"lpips_ssim_path {name}")
            against_cpu[name] = {"max_abs_err": err, "card": float(card_m[name].compute()), "cpu": float(cpu_m[name].compute())}
    cpu_s = time.perf_counter() - t_cpu
    # streamed SSIM against the accumulate mode on the card
    stream = mtt.StructuralSimilarityIndexMeasure(data_range=1.0, streaming=True, device=dev)
    accumulate = mtt.StructuralSimilarityIndexMeasure(data_range=1.0, device=dev)
    with torch.no_grad():
        for i in range(PAIR_STREAM_CHECK // FID_BATCH + 1):
            real, fake = image_pair_batch(i, FID_BATCH, dev)
            n = min(FID_BATCH, PAIR_STREAM_CHECK - i * FID_BATCH)
            if n <= 0:
                break
            for m in (stream, accumulate):
                m.update(*inputs("ssim", real[:n], fake[:n]))
    stream_err = _close_or_fail(stream.compute(), accumulate.compute(), IMG_RTOL, IMG_ATOL, "streamed against accumulated SSIM")
    del accumulate
    torch.cuda.empty_cache()
    # the whole set
    metrics = build(dev)
    update_s = {name: [] for name in metrics}
    batches = PAIR_IMAGES // FID_BATCH
    with torch.no_grad():
        for i in range(batches):
            real, fake = image_pair_batch(i, FID_BATCH, dev)
            for name, m in metrics.items():
                args = inputs(name, real, fake)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.update(*args)
                torch.cuda.synchronize()
                update_s[name].append(time.perf_counter() - t0)
    graphs = graph_stats({k: v for k, v in metrics.items() if k != "lpips"})
    for name, g in graphs.items():
        if (g["captures"], g["replays"], g["capture_error"]) != (1, batches - 1, None):
            raise AssertionError(f"lpips_ssim_path: {name}'s update was not captured once and replayed: {g}")
    values = {name: float(m.compute()) for name, m in metrics.items()}
    if not (0 < values["ssim"] < 1 and 0 < values["ms_ssim"] < 1 and values["lpips"] > 0 and math.isfinite(values["psnr"])):
        raise AssertionError(f"lpips_ssim_path: values {values}")
    emit({
        "phase": "lpips_ssim_path",
        "nvidia_smi": nvidia_smi_line(),
        "config": {"pairs": PAIR_IMAGES, "size": IMG_SIZE, "batch": FID_BATCH, "lpips_net": "alex, seeded random weights (uncalibrated)",
                   "ssim_mode": "streaming", "ms_ssim_mode": "streaming", "psnr_data_range": 1.0},
        "values": values,
        "against_cpu": {"pairs": PAIR_CPU, "rtol": IMG_RTOL, "atol": IMG_ATOL, **against_cpu},
        "stream_vs_accumulate": {"pairs": PAIR_STREAM_CHECK, "max_abs_err": stream_err},
        "pairs_per_s": {name: PAIR_IMAGES / sum(v) for name, v in update_s.items()},
        "update_p50_ms": {name: _p(v, 50) for name, v in update_s.items()},
        "update_p99_ms": {name: _p(v, 99) for name, v in update_s.items()},
        "graphs": graphs,
        "cpu_reference_s": cpu_s,
        "kernel_launches": _check_no_kernel_launched("lpips_ssim_path"),
        "seconds": time.perf_counter() - t_phase,
    })


# -- the text slice (phases 29-30) -------------------------------------------


_TOKEN_RE = None


def _tokens(text):
    """Words and punctuation marks, lowercased (the tokenizer stand-in's split)."""
    import re

    global _TOKEN_RE
    if _TOKEN_RE is None:
        _TOKEN_RE = re.compile(r"\w+|[^\w\s]")
    return _TOKEN_RE.findall(text.lower())


_LEXICONS = {}


def make_lexicon(seed):
    """LEXICON distinct lowercase pseudo-words of 1 + Poisson(3.2) letters
    (about 4.8, since short words repeat and are drawn again) and their
    Zipf probabilities, rank k weighing k^-ZIPF_S (made once a seed)."""
    import numpy as np

    if seed in _LEXICONS:
        return _LEXICONS[seed]
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words, seen = [], set()
    while len(words) < LEXICON:
        lens = 1 + rng.poisson(3.2, LEXICON)
        chars = rng.choice(letters, int(lens.sum()))
        ends = np.cumsum(lens)
        for start, end in zip(ends - lens, ends):
            w = "".join(chars[start:end])
            if w not in seen:
                seen.add(w)
                words.append(w)
    p = np.arange(1, LEXICON + 1, dtype=np.float64) ** -ZIPF_S
    _LEXICONS[seed] = np.array(words[:LEXICON]), p / p.sum()
    return _LEXICONS[seed]


class _WordSource:
    """Zipf words of the one lexicon, drawn in bulk from a generator seeded
    with ``seed``."""

    def __init__(self, seed):
        import numpy as np

        self.lexicon, self.p = make_lexicon(SEED)
        self.rng = np.random.default_rng(seed + 1)
        self.buffer, self.at = [], 0

    def take(self, n):
        if self.at + n > len(self.buffer):
            self.buffer = list(self.lexicon[self.rng.choice(LEXICON, max(1 << 20, n), p=self.p)])
            self.at = 0
        out = self.buffer[self.at:self.at + n]
        self.at += n
        return out


def _sentence(words, rng):
    """Words joined by spaces, a comma after COMMA_SHARE of them (not the
    last), a period at the end."""
    commas = rng.random(len(words)) < COMMA_SHARE
    parts = [w + ("," if c and i < len(words) - 1 else "") for i, (w, c) in enumerate(zip(words, commas))]
    return " ".join(parts) + "."


def _edit_words(words, source, rng, sub, dele, ins, swap=0.0):
    """Seeded word substitutions, deletions, insertions and adjacent swaps."""
    out = []
    draws = rng.random((len(words), 3))
    for w, (a, b, c) in zip(words, draws):
        if a < dele:
            continue
        out.append(source.take(1)[0] if b < sub else w)
        if c < ins:
            out.append(source.take(1)[0])
    if swap:
        for i in range(len(out) - 1):
            if rng.random() < swap:
                out[i], out[i + 1] = out[i + 1], out[i]
    return out


def make_summaries(seed):
    """CNNDM_PAIRS (candidate, reference) summaries. A reference is 3-4
    sentences of 1 + Poisson(13.1) Zipf words (about CNNDM_WORDS tokens with
    its commas and periods), joined by "\\n"; its candidate drops 15 % of
    the sentences (keeping two, so that every summary splits at a newline),
    then deletes and substitutes 10 % of the words and inserts after 5 %."""
    import numpy as np

    source = _WordSource(seed)
    rng = np.random.default_rng(seed + 2)
    cands, refs = [], []
    for _ in range(CNNDM_PAIRS):
        sents = [source.take(1 + rng.poisson(13.1)) for _ in range(rng.integers(CNNDM_SENTENCES[0], CNNDM_SENTENCES[1] + 1))]
        refs.append("\n".join(_sentence(s, rng) for s in sents))
        kept = [s for s in sents if rng.random() >= 0.15]
        kept = kept if len(kept) >= 2 else sents[:2]
        cands.append("\n".join(_sentence(_edit_words(s, source, rng, 0.1, 0.1, 0.05) or s[:1], rng) for s in kept))
    return cands, refs


def make_asr(seed):
    """LIBRISPEECH_UTTERANCES (hypothesis, reference) transcripts: 1 +
    Poisson(19) Zipf words, no punctuation; hypotheses at ASR_ERRORS."""
    import numpy as np

    source = _WordSource(seed + 10)
    rng = np.random.default_rng(seed + 11)
    hyps, refs = [], []
    for _ in range(LIBRISPEECH_UTTERANCES):
        words = source.take(1 + rng.poisson(LIBRISPEECH_WORDS - 1))
        refs.append(" ".join(words))
        hyps.append(" ".join(_edit_words(words, source, rng, *ASR_ERRORS)))
    return hyps, refs


def make_mt(seed):
    """WMT14_SEGMENTS (hypothesis, reference) segments of 10-40 Zipf words
    with commas and a period; hypotheses at MT_ERRORS (adjacent swaps give
    TER its shifts)."""
    import numpy as np

    source = _WordSource(seed + 20)
    rng = np.random.default_rng(seed + 21)
    hyps, refs = [], []
    for _ in range(WMT14_SEGMENTS):
        words = source.take(int(rng.integers(WMT14_WORDS[0], WMT14_WORDS[1] + 1)))
        refs.append(_sentence(words, rng))
        hyps.append(_sentence(_edit_words(words, source, rng, *MT_ERRORS) or words[:1], rng))
    return hyps, refs


def make_squad(seed):
    """SQUAD_QUESTIONS questions with one to three gold answers (1-5 Zipf
    words, the later ones a word shorter or longer); predictions: 65 % a
    gold answer (with "the " in front of a third of them), 25 % a gold
    answer with a word dropped or added, 10 % other words."""
    import numpy as np

    source = _WordSource(seed + 30)
    rng = np.random.default_rng(seed + 31)
    preds, target = [], []
    for i in range(SQUAD_QUESTIONS):
        first = source.take(int(rng.integers(1, 6)))
        golds = [first]
        for _ in range(int(rng.integers(0, 3))):
            golds.append(first[:-1] if len(first) > 1 and rng.random() < 0.5 else first + source.take(1))
        r = rng.random()
        if r < 0.65:
            pred = (["the"] if rng.random() < 1 / 3 else []) + golds[int(rng.integers(0, len(golds)))]
        elif r < 0.9:
            pred = first[1:] + source.take(1) if len(first) > 1 else first + source.take(1)
        else:
            pred = source.take(int(rng.integers(1, 4)))
        qid = f"q{i}"
        preds.append({"prediction_text": " ".join(pred), "id": qid})
        target.append({"answers": {"answer_start": [0] * len(golds), "text": [" ".join(g) for g in golds]}, "id": qid})
    return preds, target


class HashWordPiece:
    """The tokenizer stand-in of the summarization phase: no ``vocab.txt``
    is in the repository, so each lowercased word or punctuation mark is
    hashed (CRC32) into bert-base's ids past [SEP]; [CLS] 101, [SEP] 102,
    pad 0, each batch padded to its longest row, at most ``max_length``
    tokens. ``(texts, max_length) -> (ids, mask)``, int32 numpy."""

    def __init__(self, vocab_size=30522):
        self.vocab_size = vocab_size
        self.ids = {}

    def _id(self, token):
        i = self.ids.get(token)
        if i is None:
            import zlib

            i = self.ids[token] = SEP_ID + 1 + zlib.crc32(token.encode("utf-8")) % (self.vocab_size - SEP_ID - 1)
        return i

    def __call__(self, texts, max_length):
        import numpy as np

        rows = [[CLS_ID] + [self._id(t) for t in _tokens(s)[: max_length - 2]] + [SEP_ID] for s in texts]
        length = max(len(r) for r in rows)
        ids = np.full((len(rows), length), PAD_ID, np.int32)
        mask = np.zeros((len(rows), length), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask


def _host_launches(fn):
    """Kernel launches the host makes in one call of ``fn`` (a profiler
    window over it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CUDA and e.key.startswith(LAUNCH_CALLS))


def _timed(fn):
    """``fn()`` between two synchronizes: its value and seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _states_equal(card, cpu, what, rtol=0.0):
    """Every state of the card's metric equal to the CPU run's (float32
    sums within ``rtol`` where it is given)."""
    import torch

    a, b = card.metric_state, cpu.metric_state
    for key in a:
        x, y = a[key], b[key]
        xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
        if len(xs) != len(ys):
            raise AssertionError(f"{what}: {key} holds {len(xs)} items on the card, {len(ys)} on the CPU")
        for u, v in zip(xs, ys):
            u = u.cpu()
            ok = torch.equal(u, v) if rtol == 0.0 or not u.is_floating_point() else torch.allclose(u, v, rtol=rtol, atol=0.0)
            if not ok:
                raise AssertionError(f"{what}: state {key} is {u.flatten()[:4].tolist()} on the card, {v.flatten()[:4].tolist()} on the CPU")


def _bert_float64(metric):
    """BERTScore's P/R/F1 recomputed in float64 on the card from the
    metric's own embeddings and masks, batch by batch (uniform weights),
    as a (3, N) tensor."""
    import torch

    from metrics_tpu_torch.functional.text.bert import _strip_special_tokens

    def unit(e, m):
        e = e.double()
        n = e.norm(dim=-1, keepdim=True)
        return e / torch.where(n > 0, n, 1.0) * m[..., None]

    def scale(m):
        d = m.sum(-1, keepdim=True)
        return m / torch.where(d > 0, d, 1.0)

    out = []
    for pe, pm, te, tm in zip(metric.pred_embeddings, metric.pred_masks, metric.target_embeddings, metric.target_masks):
        pm, tm = _strip_special_tokens(pm).double(), _strip_special_tokens(tm).double()
        cos = torch.bmm(unit(pe, pm), unit(te, tm).transpose(1, 2))
        p = (cos.max(2).values * scale(pm)).sum(-1)
        r = (cos.max(1).values * scale(tm)).sum(-1)
        f = torch.where(p + r > 0, 2 * p * r / torch.where(p + r > 0, p + r, 1.0), 0.0)
        out.append(torch.stack([p, r, f]))
    return torch.cat(out, dim=1)


def phase_text_summarization(dev):
    """``configs[4]``'s text half: a CNN/DailyMail-test-sized summarization
    evaluation (11,490 seeded pairs) through ROUGE and BERTScore with a
    seeded BERT-base on the card."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    import metrics_tpu_torch.text.rouge as rouge_module
    from metrics_tpu_torch.functional.text import bert_score
    from metrics_tpu_torch.functional.text.rouge import ALLOWED_ROUGE_KEYS
    from metrics_tpu_torch.nets import BertConfigLite, BertEncoder

    t_phase = time.perf_counter()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    cands, refs = make_summaries(SEED)
    corpus_s = time.perf_counter() - t0
    n = len(cands)
    ref_tokens = [len(_tokens(r)) for r in refs]
    corpus = {"pairs": n, "reference_tokens_mean": float(np.mean(ref_tokens)), "candidate_tokens_mean": float(np.mean([len(_tokens(c)) for c in cands])),
              "reference_sentences_mean": float(np.mean([r.count("\n") + 1 for r in refs])), "made_on_host_s": corpus_s}

    # ROUGE over every pair on the card, each batch's per-pair values kept
    keys = ("rouge1", "rouge2", "rougeL", "rougeLsum")
    recorded = []
    original = rouge_module._rouge_score_update

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        recorded.append(out)
        return out

    rouge_module._rouge_score_update = recording
    try:
        rouge = mtt.ROUGEScore(rouge_keys=keys, device=dev)
        t0 = time.perf_counter()
        for lo in range(0, n, SUMM_BATCH):
            rouge.update(cands[lo:lo + SUMM_BATCH], refs[lo:lo + SUMM_BATCH])
        rouge_values = {k: float(v) for k, v in rouge.compute().items()}
        rouge_s = time.perf_counter() - t0
    finally:
        rouge_module._rouge_score_update = original
    mean_err = {}
    for key in keys:
        for stat in ("fmeasure", "precision", "recall"):
            vals = [s[stat] for out in recorded for s in out[ALLOWED_ROUGE_KEYS[key]]]
            mean64 = math.fsum(vals) / len(vals)
            name = f"{key}_{stat}"
            mean_err[name] = abs(rouge_values[name] - mean64) / abs(mean64)
            if len(vals) != n or mean_err[name] > ROUGE_MEAN_RTOL:
                raise AssertionError(f"text_summarization_path: {name} {rouge_values[name]} against the float64 mean {mean64} of {len(vals)} pairs")
    # the first pairs on the card and on the CPU: the same states
    t0 = time.perf_counter()
    card_rouge, cpu_rouge = mtt.ROUGEScore(rouge_keys=keys, device=dev), mtt.ROUGEScore(rouge_keys=keys, device="cpu")
    for lo in range(0, ROUGE_CPU_PAIRS, SUMM_BATCH):
        for m in (card_rouge, cpu_rouge):
            m.update(cands[lo:lo + SUMM_BATCH], refs[lo:lo + SUMM_BATCH])
    _states_equal(card_rouge, cpu_rouge, "text_summarization_path ROUGE")
    if {k: float(v) for k, v in card_rouge.compute().items()} != {k: float(v) for k, v in cpu_rouge.compute().items()}:
        raise AssertionError("text_summarization_path: ROUGE on the card and on the CPU differ")
    rouge_cpu_s = time.perf_counter() - t0

    # BERTScore: seeded BERT-base, layer 9, batches of SUMM_BATCH pairs
    tokenizer = HashWordPiece()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    encoder = _quiet(lambda: BertEncoder(tokenizer, cfg=BertConfigLite(), layer=BERT_LAYER, max_length=BERT_MAX_LENGTH, device=dev))
    encoder_init_s = time.perf_counter() - t0
    seen = set()
    hook = encoder.module.register_forward_pre_hook(
        lambda m, a: seen.add((torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32, torch.is_grad_enabled())))
    metric = mtt.BERTScore(encoder=encoder, max_length=BERT_MAX_LENGTH, device=dev)
    update_s = []
    for lo in range(0, n, SUMM_BATCH):
        _, s = _timed(lambda: metric.update(cands[lo:lo + SUMM_BATCH], refs[lo:lo + SUMM_BATCH]))
        update_s.append(s)
    hook.remove()
    if seen != {("highest", False, False)}:
        raise AssertionError(f"text_summarization_path: the encoder ran with (matmul precision, TF32, grad) {seen}")
    real_tokens = sum(int(m.sum()) for m in metric.pred_masks + metric.target_masks)
    padded_tokens = sum(m.numel() for m in metric.pred_masks + metric.target_masks)
    state_bytes = sum(t.numel() * t.element_size() for name in ("pred_embeddings", "target_embeddings", "pred_masks", "target_masks", "pred_ids", "target_ids")
                      for t in getattr(metric, name))
    values, compute_s = _timed(metric.compute)
    peak = torch.cuda.max_memory_allocated()
    p, r, f1 = values["precision"], values["recall"], values["f1"]
    if f1.shape != (n,) or not bool(torch.isfinite(torch.stack([p, r, f1])).all()) or not bool(((f1 > 0) & (f1 <= 1 + 1e-6)).all()):
        raise AssertionError(f"text_summarization_path: BERTScore F1 of shape {tuple(f1.shape)}, range [{float(f1.min())}, {float(f1.max())}]")
    f64 = _bert_float64(metric)
    f64_err = float((torch.stack([p, r, f1]).double() - f64).abs().max())
    if f64_err > BERT_F64_ATOL:
        raise AssertionError(f"text_summarization_path: the matching is {f64_err} off its float64 recomputation")
    # IDF at the corpus's size: a second metric loads the first one's state
    metric.persistent(True)
    idf_metric = mtt.BERTScore(idf=True, encoder=encoder, max_length=BERT_MAX_LENGTH, device=dev)
    state = metric.state_dict()
    idf_metric.load_state_dict(state)
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    idf_values, compute_idf_s = _timed(idf_metric.compute)
    peak_idf = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(idf_values["f1"]).all()) or idf_values["f1"].shape != (n,):
        raise AssertionError("text_summarization_path: BERTScore with IDF is not finite")
    del idf_metric, idf_values
    torch.cuda.empty_cache()

    # the first pairs against BERT-base on the CPU, with the same seeded weights
    first = slice(0, BERT_CPU_PAIRS)
    t0 = time.perf_counter()
    cpu_encoder = _quiet(lambda: BertEncoder(tokenizer, cfg=BertConfigLite(), layer=BERT_LAYER, max_length=BERT_MAX_LENGTH, device="cpu"))
    card_first = bert_score(cands[first], refs[first], encoder=encoder, device=dev)
    cpu_first = bert_score(cands[first], refs[first], encoder=cpu_encoder, device="cpu")
    cpu_err = max(float((card_first[k].cpu() - cpu_first[k]).abs().max()) for k in card_first)
    bert_cpu_s = time.perf_counter() - t0
    del cpu_encoder
    if cpu_err > BERT_CPU_ATOL:
        raise AssertionError(f"text_summarization_path: BERTScore on the card is {cpu_err} off the CPU run")
    # candidates equal to their references score 1; the own reference beats a shuffled one
    head = slice(0, SUMM_BATCH)
    self_f1 = bert_score(refs[head], refs[head], encoder=encoder, device=dev)["f1"]
    self_err = float((self_f1 - 1.0).abs().max())
    own = float(bert_score(cands[head], refs[head], encoder=encoder, device=dev)["f1"].mean())
    shuffled = float(bert_score(cands[head], refs[head][1:] + refs[head][:1], encoder=encoder, device=dev)["f1"].mean())
    if self_err > BERT_SELF_ATOL or not own > shuffled:
        raise AssertionError(f"text_summarization_path: self F1 off 1 by {self_err}; own-reference F1 {own}, shuffled {shuffled}")
    emb = metric.pred_embeddings[0][metric.pred_masks[0].bool()]
    unit = torch.nn.functional.normalize(emb.double(), dim=-1)
    g = torch.Generator(device=dev).manual_seed(SEED)
    a, b = (torch.randint(0, unit.shape[0], (4096,), generator=g, device=dev) for _ in range(2))
    token_cos = float((unit[a] * unit[b]).sum(-1)[a != b].mean())
    tokens_per_s = real_tokens / sum(update_s)
    emit({
        "phase": "text_summarization_path",
        "nvidia_smi": nvidia_smi_line(),
        "corpus": corpus,
        "rouge": {"keys": list(keys), "values": rouge_values, "host_s": rouge_s, "batches": len(recorded),
                  "float64_mean_rel_err": mean_err, "rtol": ROUGE_MEAN_RTOL,
                  "against_cpu": {"pairs": ROUGE_CPU_PAIRS, "states": "equal", "seconds": rouge_cpu_s}},
        "bert_score": {
            "encoder": {"config": "bert-base (12 layers, 768 wide, 12 heads, 30,522 ids), seeded random weights (uncalibrated)",
                        "layer": BERT_LAYER, "layers_run": BERT_LAYER, "max_length": BERT_MAX_LENGTH, "tokenizer": "hash WordPiece stand-in (no vocab.txt)",
                        "init_s": encoder_init_s, "float32": "full (matmul precision 'highest', TF32 off)"},
            "batch_pairs": SUMM_BATCH, "batches": len(update_s),
            "pairs_per_s": n / sum(update_s), "real_tokens_per_s": tokens_per_s,
            "update_p50_ms": _p(update_s, 50), "update_p99_ms": _p(update_s, 99),
            "tokens": {"real": real_tokens, "padded": padded_tokens},
            "compute_s": compute_s, "compute_idf_s": compute_idf_s,
            "state_bytes": state_bytes, "held_before_bytes": held_before,
            "peak_bytes": peak, "peak_idf_bytes": peak_idf,
            "mean": {"precision": float(p.mean()), "recall": float(r.mean()), "f1": float(f1.mean())},
            "float64_max_abs_err": f64_err, "float64_atol": BERT_F64_ATOL,
            "against_cpu": {"pairs": BERT_CPU_PAIRS, "max_abs_err": cpu_err, "atol": BERT_CPU_ATOL, "seconds": bert_cpu_s},
            "self_f1_max_abs_err": self_err, "own_reference_f1": own, "shuffled_reference_f1": shuffled,
            "token_cosine_mean": token_cos,
        },
        "kernel_launches": _check_no_kernel_launched("text_summarization_path"),
        "seconds": time.perf_counter() - t_phase,
    })
    del metric, encoder, values
    torch.cuda.empty_cache()


def _levenshtein(a, b):
    """Levenshtein distance of two token sequences on the host, in plain
    Python: the bit-parallel form of the DP (Myers 1999, Hyyro 2001), one
    column of the table per token of ``b`` as Python integers. The CPU tests
    check it against the cell-by-cell DP."""
    if not a:
        return len(b)
    m = len(a)
    peq = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask, high = (1 << m) - 1, 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = (mv | ~(xh | pv)) & mask
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = (mh | ~(xv | ph)) & mask
        mv = ph & xv
    return score


def _run_batches(metrics, batches, update_s=None):
    """Every batch through every metric, each update timed when
    ``update_s`` is given."""
    for args in batches:
        for name, m in metrics.items():
            if update_s is None:
                m.update(*args)
            else:
                _, s = _timed(lambda: m.update(*args))
                update_s.setdefault(name, []).append(s)


def phase_text_metrics(dev):
    """Every other text class on the card against the port's CPU run:
    LibriSpeech-test-clean-sized ASR (WER, CER, MER, WIL, WIP), WMT14
    newstest2014-sized MT (BLEU, SacreBLEU 13a, chrF++, TER, EED) and SQuAD
    v1.1-dev-sized QA."""
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.functional.text.eed import _preprocess_en
    from metrics_tpu_torch.functional.text.helper import _bucket

    t_phase = time.perf_counter()
    _reset_kernel_counts()
    update_s = {}

    # ASR: the counts bit-equal to the CPU run and to a plain Levenshtein
    t0 = time.perf_counter()
    hyps, refs = make_asr(SEED)
    asr_corpus_s = time.perf_counter() - t0
    asr_classes = {"wer": mtt.WordErrorRate, "cer": mtt.CharErrorRate, "mer": mtt.MatchErrorRate, "wil": mtt.WordInfoLost, "wip": mtt.WordInfoPreserved}
    asr_batches = [(hyps[lo:lo + TEXT_BATCH], refs[lo:lo + TEXT_BATCH]) for lo in range(0, len(hyps), TEXT_BATCH)]
    card = {k: c(device=dev) for k, c in asr_classes.items()}
    _run_batches(card, asr_batches[:TEXT_CPU_BATCHES], update_s)
    t0 = time.perf_counter()
    cpu = {k: c(device="cpu") for k, c in asr_classes.items()}
    _run_batches(cpu, asr_batches[:TEXT_CPU_BATCHES])
    asr_cpu_s = time.perf_counter() - t0
    for k in card:
        _states_equal(card[k], cpu[k], f"text_metrics_path {k}")
    _run_batches(card, asr_batches[TEXT_CPU_BATCHES:], update_s)
    t0 = time.perf_counter()
    word_d = sum(_levenshtein(h.split(), r.split()) for h, r in zip(hyps, refs))
    char_d = sum(_levenshtein(h, r) for h, r in zip(hyps, refs))
    hyp_words, ref_words = sum(len(h.split()) for h in hyps), sum(len(r.split()) for r in refs)
    max_words = sum(max(len(h.split()), len(r.split())) for h, r in zip(hyps, refs))
    plain_s = time.perf_counter() - t0
    want = {"wer": (word_d, ref_words), "cer": (char_d, sum(len(r) for r in refs)), "mer": (word_d, max_words),
            "wil": (word_d - max_words, ref_words, hyp_words), "wip": (word_d - max_words, ref_words, hyp_words)}
    for k, m in card.items():
        got = tuple(float(v) for v in m.metric_state.values())
        if got != tuple(float(v) for v in want[k]):
            raise AssertionError(f"text_metrics_path: {k} counts {got} against the plain Levenshtein's {want[k]}")
    asr_values = {k: float(m.compute()) for k, m in card.items()}
    # the wavefront's launches on one batch, beside its anti-diagonals
    h0, r0 = asr_batches[0]
    wavefront = {}
    for k, split in (("wer", str.split), ("cer", list)):
        m = asr_classes[k](device=dev)
        diagonals = _bucket(max(len(split(h)) for h in h0)) + _bucket(max(len(split(r)) for r in r0)) - 1
        launches = _host_launches(lambda: m.update(h0, r0))
        wavefront[k] = {"launches_per_batch": launches, "anti_diagonals": diagonals, "launches_per_diagonal": launches / diagonals}

    # MT
    t0 = time.perf_counter()
    mt_hyps, mt_refs = make_mt(SEED)
    mt_corpus_s = time.perf_counter() - t0
    mt_targets = [[r] for r in mt_refs]
    mt_classes = {"bleu": lambda d: mtt.BLEUScore(device=d), "sacrebleu": lambda d: mtt.SacreBLEUScore(tokenize="13a", device=d),
                  "chrf": lambda d: mtt.CHRFScore(device=d), "eed": lambda d: mtt.ExtendedEditDistance(device=d)}
    mt_batches = [(mt_hyps[lo:lo + TEXT_BATCH], mt_targets[lo:lo + TEXT_BATCH]) for lo in range(0, len(mt_hyps), TEXT_BATCH)]
    card_mt = {k: c(dev) for k, c in mt_classes.items()}
    _run_batches(card_mt, mt_batches[:TEXT_CPU_BATCHES], update_s)
    t0 = time.perf_counter()
    cpu_mt = {k: c("cpu") for k, c in mt_classes.items()}
    _run_batches(cpu_mt, mt_batches[:TEXT_CPU_BATCHES])
    mt_cpu_s = time.perf_counter() - t0
    mt_cpu_err = {}
    for k in card_mt:
        _states_equal(card_mt[k], cpu_mt[k], f"text_metrics_path {k}", rtol=1e-6 if k == "eed" else 0.0)
        a, b = float(card_mt[k].compute()), float(cpu_mt[k].compute())
        mt_cpu_err[k] = abs(a - b) / max(abs(b), 1e-30)
        if not math.isfinite(a) or mt_cpu_err[k] > 1e-6:
            raise AssertionError(f"text_metrics_path: {k} {a} on the card, {b} on the CPU")
    _run_batches(card_mt, mt_batches[TEXT_CPU_BATCHES:], update_s)
    mt_values = {k: float(m.compute()) for k, m in card_mt.items()}
    # TER's host shift search: the first TER_CARD_SEGMENTS segments, the CPU
    # run the first TER_CPU_SEGMENTS of them
    ter_batch = TER_CPU_SEGMENTS // 2
    ter_batches = [(mt_hyps[lo:lo + ter_batch], mt_targets[lo:lo + ter_batch]) for lo in range(0, TER_CARD_SEGMENTS, ter_batch)]
    card_ter, cpu_ter = {"ter": mtt.TranslationEditRate(device=dev)}, {"ter": mtt.TranslationEditRate(device="cpu")}
    _run_batches(card_ter, ter_batches[:2], update_s)
    t0 = time.perf_counter()
    _run_batches(cpu_ter, ter_batches[:2])
    ter_cpu_s = time.perf_counter() - t0
    _states_equal(card_ter["ter"], cpu_ter["ter"], "text_metrics_path ter")
    _run_batches(card_ter, ter_batches[2:], update_s)
    mt_values["ter"] = float(card_ter["ter"].compute())
    eed_m = mtt.ExtendedEditDistance(device=dev)
    mt_h0, mt_t0 = mt_batches[0]
    eed_steps = _bucket(max(len(_preprocess_en(r[0])) for r in mt_t0))
    eed_launches = _host_launches(lambda: eed_m.update(mt_h0, mt_t0))

    # QA
    t0 = time.perf_counter()
    qa_preds, qa_target = make_squad(SEED)
    qa_corpus_s = time.perf_counter() - t0
    qa_batches = [(qa_preds[lo:lo + TEXT_BATCH], qa_target[lo:lo + TEXT_BATCH]) for lo in range(0, len(qa_preds), TEXT_BATCH)]
    card_qa, cpu_qa = {"squad": mtt.SQuAD(device=dev)}, {"squad": mtt.SQuAD(device="cpu")}
    _run_batches(card_qa, qa_batches, update_s)
    t0 = time.perf_counter()
    _run_batches(cpu_qa, qa_batches)
    qa_cpu_s = time.perf_counter() - t0
    _states_equal(card_qa["squad"], cpu_qa["squad"], "text_metrics_path squad")
    qa_values = {k: float(v) for k, v in card_qa["squad"].compute().items()}
    if int(card_qa["squad"].total) != SQUAD_QUESTIONS or not 0 < qa_values["f1"] <= 100:
        raise AssertionError(f"text_metrics_path: SQuAD {qa_values} over {int(card_qa['squad'].total)} questions")

    emit({
        "phase": "text_metrics_path",
        "nvidia_smi": nvidia_smi_line(),
        "asr": {"utterances": len(hyps), "words_mean": ref_words / len(refs), "values": asr_values,
                "counts": {k: [float(v) for v in m.metric_state.values()] for k, m in card.items()},
                "against_cpu": f"states equal over the first {TEXT_CPU_BATCHES * TEXT_BATCH}", "against_plain_levenshtein": "counts equal",
                "plain_levenshtein_s": plain_s,
                "cpu_s": asr_cpu_s, "corpus_s": asr_corpus_s, "wavefront": wavefront},
        "mt": {"segments": len(mt_hyps), "values": mt_values, "cpu_segments": TEXT_CPU_BATCHES * TEXT_BATCH, "against_cpu_rel_err": mt_cpu_err,
               "ter_segments": {"card": TER_CARD_SEGMENTS, "cpu": TER_CPU_SEGMENTS}, "cpu_s": mt_cpu_s, "ter_cpu_s": ter_cpu_s,
               "corpus_s": mt_corpus_s, "eed_loop": {"launches_per_batch": eed_launches, "reference_steps": eed_steps,
                                                     "launches_per_step": eed_launches / eed_steps}},
        "qa": {"questions": len(qa_preds), "values": qa_values, "against_cpu": "states equal", "cpu_s": qa_cpu_s, "corpus_s": qa_corpus_s},
        "batch": TEXT_BATCH,
        "update_p50_ms": {k: _p(v, 50) for k, v in update_s.items()},
        "update_p99_ms": {k: _p(v, 99) for k, v in update_s.items()},
        "update_s_total": {k: sum(v) for k, v in update_s.items()},
        "kernel_launches": _check_no_kernel_launched("text_metrics_path"),
        "seconds": time.perf_counter() - t_phase,
    })


# ----------------------------------------------------------------------
# resilience and observability: the bootstrap probe, snapshots, drift, and
# the served evaluation with tracing, drift and snapshots on
# ----------------------------------------------------------------------


def start_backend_probe():
    """``ensure_backend()`` on a thread, started before this process
    initialises CUDA, so that its probe (a fresh interpreter that
    initialises CUDA, about 10 s) runs while the kernels build and the
    parity phases run. Returns once the thread is past ``ensure_backend``'s
    is-CUDA-initialised check (it has entered ``probe_backend``, or ended):
    only then may this process initialise CUDA."""
    import threading

    from metrics_tpu_torch.utilities import backend

    out, started = {}, threading.Event()
    probe_backend = backend.probe_backend

    def probe_started(*args, **kwargs):
        started.set()
        return probe_backend(*args, **kwargs)

    def run():
        t0 = time.perf_counter()
        try:
            out["platform"] = backend.ensure_backend()
        except BaseException as err:  # noqa: BLE001 - reported by phase_backend_probe
            out["error"] = f"{type(err).__name__}: {err}"
        finally:
            started.set()
        out["wall_s"] = time.perf_counter() - t0

    backend.probe_backend = probe_started
    with budget_time(NEW_PHASE_S, "backend_probe"):
        thread = threading.Thread(target=run, daemon=True, name="backend-probe")
        thread.start()
        if not started.wait(timeout=120):
            fail("backend_probe: ensure_backend() did not reach its probe within 120 s")
    backend.probe_backend = probe_backend
    return thread, out


def phase_backend_probe(probe):
    import metrics_tpu_torch as mtt

    thread, out = probe
    thread.join(timeout=300)
    if thread.is_alive() or "error" in out:
        raise AssertionError(f"backend_probe: ensure_backend() {out.get('error', 'did not return within 300 s')}")
    backend = mtt.health_report()["backend"]
    probe = backend["probe"]
    if out["platform"] != "cuda" or probe is None or not probe["ok"] or probe["platform"] != "cuda":
        raise AssertionError(f"backend_probe: ensure_backend() gave {out['platform']!r}, probe {probe}")
    if backend["forced_cpu"] or backend["force_cpu_env"]:
        raise AssertionError(f"backend_probe: health_report()['backend'] {backend}")
    emit({"phase": "backend_probe", "platform": out["platform"], "device": probe["device"], "elapsed_s": probe["elapsed_s"],
          "ensure_backend_wall_s": out["wall_s"], "health_backend": backend})


def save_rank_snapshot(mtt, coll, tag, rank, world):
    """A rank's local state saved as rank ``rank`` of ``world`` under
    ``SNAPSHOT_DIR_ENV``: its bytes and seconds."""
    mgr = mtt.SnapshotManager(os.environ[SNAPSHOT_DIR_ENV], tag=tag)
    t0 = time.perf_counter()
    path = mgr.save(coll, step=1, rank=rank, world_size=world)
    return {"bytes": os.path.getsize(path), "save_s": time.perf_counter() - t0, "timings": mgr.last_save_timings}


def check_elastic_restore(dev, directory, ranks, card, synced_faults):
    """snapshot_path (a) and (c): the four ranks' files of the fused
    evaluation restored at world 1 on the card equal the synced values; a
    corrupt newest file falls back to the previous step."""
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.resilience.health import registry

    NEW_PHASE_S["snapshot_path"] = NEW_PHASE_S.get("snapshot_path", 0.0) + max(r["snapshot"]["save_s"] for r in ranks)
    mgr = mtt.SnapshotManager(directory, tag="fused_eval")
    coll = build_fused_eval(mtt, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = mgr.restore(coll, rank=0, world_size=1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    values = _values(coll.compute())
    members = dict(coll.items(keep_base=True, copy_state=False))
    if info["merged_ranks"] != list(range(DIST_WORLD)) or info["fallbacks"]:
        raise AssertionError(f"snapshot_path: restore info {info}")
    for k, v in card.items():
        if k == "bap":
            err = max(abs(a - b) for a, b in zip(values[k], v))
            if err > AP_ATOL:
                raise AssertionError(f"snapshot_path: restored BAP off the synced one by {err} (atol {AP_ATOL})")
        elif values[k] != v:
            raise AssertionError(f"snapshot_path: restored {k} {values[k]}, synced {v}")
    for name, m in members.items():
        if m.fault_counts != synced_faults[name]:
            raise AssertionError(f"snapshot_path: restored fault counts of {name} {m.fault_counts}, synced {synced_faults[name]}")
    if members["bap"].update_count != sum(r["bap_updates"] for r in ranks):
        raise AssertionError("snapshot_path: the restored update count is not the ranks' sum")
    emit({
        "phase": "snapshot_path", "part": "elastic_restore",
        "config": {"old_world": DIST_WORLD, "world": 1, "collection": "fused_dist_path's", "saved": "before compute()"},
        "bytes_per_rank": [r["snapshot"]["bytes"] for r in ranks],
        "save_s_per_rank": [r["snapshot"]["save_s"] for r in ranks],
        "save_split_rank0": ranks[0]["snapshot"]["timings"],
        "restore_s": restore_s,
        "values_equal_synced": True, "bap_max_abs_err": max(abs(a - b) for a, b in zip(values["bap"], card["bap"])),
    })
    # (c) the newest file corrupt: the restore falls back, a stale tmp is ignored
    bad = mtt.SnapshotManager(directory, tag="corrupt")
    bad.save(coll, step=2)
    newest = bad.save(coll, step=3)
    with open(newest, "r+b") as f:
        f.seek(os.path.getsize(newest) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    stale = f"{newest}.tmp.{os.getpid() + 1}"
    with open(stale, "wb") as f:
        f.write(b"a torn write")
    before = registry.counts().get("snapshot_fallback", 0)
    again = build_fused_eval(mtt, dev)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        info = bad.restore(again)
    events = registry.counts().get("snapshot_fallback", 0) - before
    if info["step"] != 2 or info["fallbacks"] != 1 or events != 1:
        raise AssertionError(f"snapshot_path: corrupt newest file: restore {info}, {events} fallback events")
    if _values(again.compute()) != values:
        raise AssertionError("snapshot_path: the fallback step's values differ")
    emit({"phase": "snapshot_path", "part": "corruption", "restored_step": info["step"], "fallbacks": info["fallbacks"],
          "fallback_events": events, "stale_tmp_ignored": os.path.exists(stale)})


def check_sketch_restore(dev, directory, ranks, folded):
    """snapshot_path: the fused sketch path's four rank files restored at
    world 1 merge their quantile sketches with K3 (three launches), bit-equal
    to the in-process fold in rank order."""
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import compactor as k3

    NEW_PHASE_S["snapshot_path"] = NEW_PHASE_S.get("snapshot_path", 0.0) + max(r["snapshot"]["save_s"] for r in ranks)
    mgr = mtt.SnapshotManager(directory, tag="fused_sketch")
    coll = build_fused_monitor(mtt, dev)
    k3.reset_launch_count()
    t0 = time.perf_counter()
    mgr.restore(coll, rank=0, world_size=1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    launches = k3.launch_count
    q = dict(coll.items(keep_base=True, copy_state=False))["q"].metric_state["sketch"]
    if not (torch.equal(q.items.cpu(), folded.items) and torch.equal(q.counts.cpu(), folded.counts) and int(q.n_seen) == int(folded.n_seen)):
        raise AssertionError("snapshot_path: the restored quantile sketch differs from the in-process fold")
    if launches != DIST_WORLD - 1:
        raise AssertionError(f"snapshot_path: the restore's merge launched K3 {launches} times for {DIST_WORLD - 1} merges")
    emit({"phase": "snapshot_path", "part": "elastic_sketch_restore", "bytes_per_rank": [r["snapshot"]["bytes"] for r in ranks],
          "restore_s": restore_s, "k3_launches": launches, "sketch_bit_equal_fold": True})
    return launches


def check_large_state(dev, metrics, per_query):
    """snapshot_path (b): MRR, MAP and nDCG@10 of the capacity-mode MS MARCO
    run (rings holding 6,668,967 rows) saved, restored into fresh metrics,
    their per-query values bit-equal."""
    import torch

    import metrics_tpu_torch as mtt

    coll = mtt.MetricCollection({name: metrics[name] for name in MSMARCO_WORLD_METRICS})
    fresh = mtt.MetricCollection(build_retrieval(mtt, dev, MSMARCO_CAPACITY, names=MSMARCO_WORLD_METRICS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_msmarco_") as tmp:
        mgr = mtt.SnapshotManager(tmp, tag="msmarco")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(coll, step=1)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        mgr.restore(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
    members = dict(fresh.items(keep_base=True, copy_state=False))
    for name in MSMARCO_WORLD_METRICS:
        m = members[name]
        got = m._row_metric(*m._grouped_capacity_matrices())
        if not torch.equal(got, per_query[name]):
            raise AssertionError(f"snapshot_path: restored per-query {name} differs from the evaluated one")
        if not torch.equal(m.compute(), metrics[name].compute()):
            raise AssertionError(f"snapshot_path: restored {name} differs")
    emit({"phase": "snapshot_path", "part": "large_state", "metrics": list(MSMARCO_WORLD_METRICS), "rows": MSMARCO_ROWS,
          "capacity": MSMARCO_CAPACITY, "file_bytes": size, "save_s": save_s, "save_split": mgr.last_save_timings,
          "restore_s": restore_s, "per_query_bit_equal": True})


def make_item_ids(dev, batch_index, g, cdf, perm, moved):
    """2^20 item ids: Zipf(1.1) ranks over ``ITEM_IDS`` by the inverse CDF,
    mapped through ``perm`` (``moved`` from the rollout on)."""
    import torch

    u = torch.rand(STREAM_BATCH, generator=g, device=dev, dtype=torch.float64)
    ranks = torch.searchsorted(cdf, u).clamp_(max=ITEM_IDS - 1)
    return (moved if batch_index >= DRIFT_SHIFT_AT else perm)[ranks]


def _live_sketch_shape(monitor):
    """(levels, k) of a drift monitor's live quantile sketch (an empty one
    is made after a rotation: no kernel runs)."""
    monitor._ensure_live_locked()
    return tuple(monitor._q.items.shape)


def _ks64(a, b):
    """The two-sample KS distance of two float arrays, in float64 numpy."""
    import numpy as np

    a, b = np.sort(a.astype(np.float64)), np.sort(b.astype(np.float64))
    grid = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, grid, side="right") / a.size - np.searchsorted(b, grid, side="right") / b.size)))


def phase_drift(x):
    """drift_path: a score monitor on the stream of phase 5, its rollout
    from batch 32, and an item-id monitor whose hot set moves there."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.obs import flightrec
    from metrics_tpu_torch.ops import compactor as k3
    from metrics_tpu_torch.resilience.health import registry

    dev = x.device
    batches = x.reshape(STREAM_BATCHES, STREAM_BATCH)
    finite = torch.isfinite(batches).sum(dim=1).tolist()
    nonfinite = STREAM_BATCHES * STREAM_BATCH - sum(finite)
    scale = torch.tensor(math.exp(DRIFT_SHIFT), dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 90)
    weights = torch.arange(1, ITEM_IDS + 1, dtype=torch.float64, device=dev).pow_(-ITEM_ZIPF)
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(ITEM_IDS, generator=g, device=dev)
    moved = perm.clone()
    moved[:ITEM_HOT] = perm[ITEM_HOT:2 * ITEM_HOT]  # the hot ranks take other ids
    moved[ITEM_HOT:2 * ITEM_HOT] = perm[:ITEM_HOT]
    score = mtt.DriftMonitor("score", window=DRIFT_WINDOW, eps=DRIFT_EPS, device=dev)
    # scored on full windows only: the cardinality ratio's uniform key
    # universe (fitted on the reference) over-expects the distinct ids of a
    # shorter Zipf window, about 0.5x at a quarter of the rows
    item = mtt.DriftMonitor("item_id", window=DRIFT_WINDOW, min_rows=DRIFT_WINDOW, device=dev)
    monitors = (score, item)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_flightrec_")
    rec = flightrec.FlightRecorder(tmp, min_interval_s=0.0)
    flightrec.install_flight_recorder(rec)
    events_before = len([e for e in registry.events() if e["kind"] == "drift_detected"])
    try:
        k3.reset_launch_count()
        observe_s, check_s, reads = [], [], 0
        statuses = {m.name: [] for m in monitors}
        bucket, reference_rows, ks_checks = [], None, []
        t_phase = time.perf_counter()
        for b in range(STREAM_BATCHES):
            batch = batches[b] * scale if b >= DRIFT_SHIFT_AT else batches[b]
            ids = make_item_ids(dev, b, g, cdf, perm, moved)
            torch.cuda.synchronize()
            for mon, values in ((score, batch), (item, ids)):
                def timed_observe(_i, mon=mon, values=values):
                    t0 = time.perf_counter()
                    mon.observe(values)
                    observe_s.append(time.perf_counter() - t0)

                reads += len(blocking_reads(timed_observe, 1))
            bucket.append(batch)
            if b == DRIFT_REFERENCE_BATCHES - 1:
                for mon in monitors:
                    mon.set_reference(mon.freeze_reference())
                    mon.rotate()
                reference_rows = torch.cat(bucket)
                reference_rows = reference_rows[torch.isfinite(reference_rows)].cpu().numpy()
                bucket = []
                continue
            for mon in monitors:
                before = mon.status()
                t0 = time.perf_counter()
                st = mon.check()
                check_s.append(time.perf_counter() - t0)
                scored = st["checks"] > before["checks"]  # a thin bucket keeps the last scores
                statuses[mon.name].append((b, st["breaching"] if scored else [], st["scores"]))
                if mon is score and scored:
                    pre = b < DRIFT_SHIFT_AT
                    post = all(i >= DRIFT_SHIFT_AT for i in range(b - len(bucket) + 1, b + 1))
                    if (pre and not any(k["pre_shift"] for k in ks_checks)) or (post and not any(not k["pre_shift"] for k in ks_checks)):
                        live = torch.cat(bucket)
                        live = live[torch.isfinite(live)].cpu().numpy()
                        exact = _ks64(live, reference_rows)
                        ks_checks.append({"batch": b, "pre_shift": pre, "ks": st["scores"]["ks"], "ks_float64": exact,
                                          "floor": score.score_floor()["ks"], "rows": int(live.size)})
                if mon is score and st["windows"] != before["windows"]:
                    bucket = []
        phase_s = time.perf_counter() - t_phase
        rec.flush()
        launches = k3.launch_count
        dumps = [r for r in flightrec.load_flight_records(tmp) if r["trigger"]["kind"] == "drift_detected"]
    finally:
        flightrec.install_flight_recorder(None)
        shutil.rmtree(tmp, ignore_errors=True)
    first_breach = {}
    for name, rows in statuses.items():
        early = [b for b, breaching, _ in rows if breaching and b < DRIFT_SHIFT_AT]
        if early:
            raise AssertionError(f"drift_path: {name} breached before the rollout at batches {early}: {[(b, br, sc) for b, br, sc in rows if br][:3]}")
        late = [b for b, breaching, _ in rows if breaching]
        if not late or late[0] > DRIFT_DETECT_BY:
            raise AssertionError(f"drift_path: {name} first breached at {late[:1]}, not by batch {DRIFT_DETECT_BY}")
        first_breach[name] = late[0]
    item_breaches = sorted({s for _, breaching, _ in statuses["item_id"] for s in breaching})
    if "hh_churn" not in item_breaches or "cardinality_ratio" in item_breaches:
        raise AssertionError(f"drift_path: item_id breached {item_breaches}; hh_churn must trip and cardinality_ratio not")
    detected = [e for e in registry.events() if e["kind"] == "drift_detected"][events_before:]
    per_monitor = {m.name: sum(1 for e in detected if e["details"]["monitor"] == m.name) for m in monitors}
    dumped = {m.name: sum(1 for d in dumps if repr(m.name) in d["trigger"]["message"]) for m in monitors}
    if per_monitor != {"score": 1, "item_id": 1} or dumped != {"score": 1, "item_id": 1}:
        raise AssertionError(f"drift_path: drift_detected events {per_monitor}, flight records {dumped}")
    shapes = {m.name: _live_sketch_shape(m) for m in monitors}
    if shapes != {"score": DRIFT_SKETCH_SHAPE, "item_id": ITEM_SKETCH_SHAPE}:
        raise AssertionError(f"drift_path: sketch shapes {shapes}, not the ones phase_k3_cascade_parity holds")
    if score.dropped_rows != nonfinite or item.dropped_rows:
        raise AssertionError(f"drift_path: dropped rows {score.dropped_rows}/{item.dropped_rows}, the stream has {nonfinite} non-finite")
    if len(ks_checks) != 2 or any(abs(k["ks"] - k["ks_float64"]) > k["floor"] for k in ks_checks):
        raise AssertionError(f"drift_path: KS against float64 {ks_checks}")
    if reads:
        raise AssertionError(f"drift_path: observe made {reads} blocking reads")
    predicted = sum(math.ceil(n / 4096) for n in finite) + STREAM_BATCHES * math.ceil(STREAM_BATCH / 4096)
    if not (launches == predicted == score.fold_chunks + item.fold_chunks):
        raise AssertionError(f"drift_path: K3 launched {launches} times, predicted {predicted} (fold chunks {score.fold_chunks}+{item.fold_chunks})")
    observe_us = sorted(observe_s)[len(observe_s) // 2] * 1e6
    emit({
        "phase": "drift_path",
        "config": {"batches": STREAM_BATCHES, "batch": STREAM_BATCH, "window": DRIFT_WINDOW, "score_eps": DRIFT_EPS,
                   "item_eps": item.eps, "reference_batches": DRIFT_REFERENCE_BATCHES, "shift_at": DRIFT_SHIFT_AT,
                   "shift": f"rows times exp({DRIFT_SHIFT})", "items": ITEM_IDS, "zipf": ITEM_ZIPF, "hot_moved": ITEM_HOT},
        "first_breach_batch": first_breach,
        "breaching_at_first_breach": {n: next(br for b, br, _ in rows if br) for n, rows in statuses.items()},
        "item_breaches": item_breaches,
        "scores_at_first_breach": {n: next(sc for b, br, sc in rows if br) for n, rows in statuses.items()},
        "drift_detected_events": per_monitor,
        "flight_records": dumped,
        "dropped_rows": score.dropped_rows,
        "ks_vs_float64": ks_checks,
        "observe_blocking_reads": reads,
        "observe_p50_us": observe_us,
        "check_p50_ms": sorted(check_s)[len(check_s) // 2] * 1e3,
        "rows_per_s_per_monitor": STREAM_BATCHES * STREAM_BATCH / (sum(observe_s) / 2 + sum(check_s) / 2),
        "k3_launches": launches,
        "k3_launches_predicted": predicted,
        "phase_s": phase_s,
    })
    return launches


def _top1_confidence(args, kwargs):
    return args[0].max(dim=1).values


def _scrape_values(text):
    """``{name{labels}: value}`` of a Prometheus text scrape."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def phase_serving_obs(preds, target, serving_latency):
    """serving_obs_path: the served epoch of serving_path again, with
    periodic snapshots, a drift monitor over the top-1 confidence, tracing
    forced on and a flight recorder installed."""
    import threading

    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.obs import flightrec
    from metrics_tpu_torch.obs import runtime_metrics as rm
    from metrics_tpu_torch.obs import trace as tr
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import compactor as k3

    dev = preds.device
    plan = serve_plan(ROWS, SEED + 11)
    example = (preds[:BATCH].cpu().numpy(), target[:BATCH].cpu().numpy())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_obs_")
    rm.registry.reset()
    rm.registry.fold_device = dev
    tr.reset_trace_state()
    rec = flightrec.FlightRecorder(os.path.join(tmp, "flightrec"), min_interval_s=0.0)
    flightrec.install_flight_recorder(rec)
    try:
        mgr = mtt.SnapshotManager(os.path.join(tmp, "snapshots"), tag="served")
        monitor = mtt.DriftMonitor("top1_confidence", window=SERVE_DRIFT_WINDOW, eps=DRIFT_EPS, device=dev, extract=_top1_confidence)
        k1.reset_launch_count()
        k3.reset_launch_count()
        with tr.force_tracing(True):
            loop = mtt.ServeLoop(_serving_proto(mtt, dev), workers=SERVE_WORKERS, queue_size=len(plan) + 1, warmup=mtt.Warmup(example),
                                 snapshot_manager=mgr, snapshot_every_s=SERVE_SNAPSHOT_EVERY_S, drift_monitors=[monitor])
            latencies = []
            timed_updates(loop, latencies, threading.Lock())
            if not loop.wait_warmup(300):
                raise AssertionError("serving_obs_path: the warmup did not end")
            captured_at_warmup = _replica_captures(loop)
            accepted = []
            t1 = time.perf_counter()
            for off, n in plan:
                if loop.offer(preds[off:off + n], target[off:off + n]):
                    accepted.append((off, n))
            if not loop.drain(300):
                raise AssertionError("serving_obs_path: the loop did not drain")
            serve_s = time.perf_counter() - t1
            view = loop.report(fresh=True, deadline_s=120)
            text = loop.scrape()
            step = loop.save_snapshot()
            periodic = [s for s in mgr.steps() if s != step]
            loop.stop()
            monitor.check()  # what the last tick left pending
            request_captures = _replica_captures(loop) - captured_at_warmup
            bap_updates = sum(_coll_members(r)["bap"].update_count for r in loop._replicas)
            trace_path = os.path.join(tmp, "trace.json")
            doc = json.loads(tr.export_chrome_trace(trace_path))
        k1_launches = k1.launch_count
        # the telemetry folded as an exporter merging workers folds it
        merged = rm.merged(rm.registry)
        hist = merged.histograms()["serve_update_ms"]
        hist_folds = sum(h.folds for h in rm.registry.histograms().values())
        shapes = {tuple(h._sketch.items.shape) for h in rm.registry.histograms().values() if h._sketch is not None}
        shapes.add(_live_sketch_shape(monitor))
        if shapes != {TELEMETRY_SKETCH_SHAPE}:
            raise AssertionError(f"serving_obs_path: sketch shapes {shapes}, not the one phase_k3_cascade_parity holds")
        k3_launches = k3.launch_count
        # a fresh loop restored from the served loop's snapshot
        fresh = mtt.ServeLoop(_serving_proto(mtt, dev), workers=SERVE_WORKERS, snapshot_manager=mgr)
        info = fresh.restore_snapshot()
        restored = fresh.report(fresh=True, deadline_s=120)
        fresh.stop()
        rec.flush()
        dumps = flightrec.load_flight_records(os.path.join(tmp, "flightrec"))
    finally:
        flightrec.install_flight_recorder(None)
        rm.registry.fold_device = None
        shutil.rmtree(tmp, ignore_errors=True)
    stats = view["stats"]
    served_rows = sum(n for _, n in accepted)
    scraped = _scrape_values(text)
    want = {"metrics_tpu_serve_offered_total": len(plan), "metrics_tpu_serve_accepted_total": len(accepted),
            "metrics_tpu_serve_processed_total": len(accepted), "metrics_tpu_serve_update_ms_count": len(accepted),
            "metrics_tpu_serve_offer_total": len(plan)}
    got = {k: scraped.get(k) for k in want}
    if got != want or not view["fresh"] or stats["failed"]:
        raise AssertionError(f"serving_obs_path: scrape counts {got}, served {want}; report {view['fresh']} {stats}")
    if monitor.folded_rows != served_rows or monitor.dropped_rows:
        raise AssertionError(f"serving_obs_path: the drift monitor folded {monitor.folded_rows} rows of {served_rows} served")
    durs = np.sort(np.array([r.dur_ns / 1e6 for r in tr.trace_records("serve.update")], np.float32))
    quantiles = hist.quantiles((0.5, 0.99))
    rank_err = {f"{q:g}": abs(int(np.searchsorted(durs, quantiles[q], side="right")) - q * durs.size) / durs.size for q in (0.5, 0.99)}
    if durs.size != len(accepted) or max(rank_err.values()) > hist.eps:
        raise AssertionError(f"serving_obs_path: serve_update_ms quantiles off by {rank_err} rank (eps {hist.eps}) over {durs.size} spans")
    spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("name") == "serve.update")
    if spans != len(accepted):
        raise AssertionError(f"serving_obs_path: the Chrome trace holds {spans} serve.update spans for {len(accepted)} requests")
    if request_captures:
        raise AssertionError(f"serving_obs_path: {request_captures} captures on the request path after wait_warmup()")
    if not (k1_launches == bap_updates == len(accepted)):
        raise AssertionError(f"serving_obs_path: K1 {k1_launches} launches, {bap_updates} BAP updates, {len(accepted)} requests")
    if k3_launches != monitor.fold_chunks + hist_folds:
        raise AssertionError(f"serving_obs_path: K3 {k3_launches} launches; the drift folds {monitor.fold_chunks} and telemetry folds {hist_folds}")
    if info["old_world"] != SERVE_WORKERS or info["step"] < step or restored["updates"] != view["updates"]:
        raise AssertionError(f"serving_obs_path: restore {info}, updates {restored['updates']} of {view['updates']}")
    for k, v in view["value"].items():
        x, z = (torch.stack(v), torch.stack(restored["value"][k])) if isinstance(v, list) else (v, restored["value"][k])
        if not torch.equal(x, z):
            raise AssertionError(f"serving_obs_path: the restored loop's {k} differs from the served loop's")
    if restored["faults"] != view["faults"]:
        raise AssertionError("serving_obs_path: the restored fault counts differ")
    lat = [dt for _, dt in latencies]
    emit({
        "phase": "serving_obs_path",
        "config": {"requests": len(plan), "workers": SERVE_WORKERS, "snapshot_every_s": SERVE_SNAPSHOT_EVERY_S,
                   "drift_monitor": {"name": monitor.name, "window": SERVE_DRIFT_WINDOW, "eps": DRIFT_EPS},
                   "tracing": "forced on", "flight_recorder": "installed"},
        "request_update_ms": {"p50": _p(lat, 50), "p99": _p(lat, 99)},
        "serving_path_request_update_ms": serving_latency,
        "rows_per_s": served_rows / serve_s,
        "scrape": got,
        "serve_update_ms_quantiles": {f"{q:g}": quantiles[q] for q in (0.5, 0.99)},
        "serve_update_ms_rank_err": rank_err,
        "periodic_snapshot_steps_kept": len(periodic),
        "restored_bit_equal": True,
        "captures_on_request_path": request_captures,
        "chrome_serve_update_spans": spans,
        "drift_folded_rows": monitor.folded_rows,
        "k1_launches": k1_launches,
        "k3_launches": k3_launches,
        "k3_predicted": {"drift_fold_chunks": monitor.fold_chunks, "telemetry_folds": hist_folds},
        "flight_records": len(dumps),
    })
    return k1_launches, k3_launches




# -- the fleet slice (phase 35) -----------------------------------------------


def _fleet_proto(mtt, dev):
    """The served collection of serving_path with ``q``, a QuantileSketch of
    each request's top-1 confidence (kept eager, as BAP)."""

    class Top1Sketch(mtt.QuantileSketch):
        jittable_update = False

        def update(self, preds, target):
            super().update(preds.max(dim=1).values)

    members = _coll_members(_serving_proto(mtt, dev))
    members["q"] = Top1Sketch(eps=FLEET_EPS, device=dev)
    return mtt.MetricCollection(members)


class _CountedSketch:
    """Counts ``QuantileSketchState`` inserts and merges (each one launch of
    K3 here), merges split by the thread that made them."""

    def __init__(self):
        import threading

        from metrics_tpu_torch.streaming.sketches import QuantileSketchState

        self.cls = QuantileSketchState
        self.inserts = 0
        self.merges = {}
        self._saved = (QuantileSketchState.insert, QuantileSketchState.sketch_merge)
        self._lock = threading.Lock()

    def __enter__(self):
        insert, merge = self._saved
        counter = self

        def counted_insert(state, values, valid=None):
            with counter._lock:
                counter.inserts += 1
            return insert(state, values, valid)

        def counted_merge(state, other):
            import threading

            who = "host_reduce" if threading.current_thread().name.startswith("metrics-tpu-async-sync") else "aggregator_fold"
            with counter._lock:
                counter.merges[who] = counter.merges.get(who, 0) + 1
            return merge(state, other)

        self.cls.insert, self.cls.sketch_merge = counted_insert, counted_merge
        return self

    def __exit__(self, *exc):
        self.cls.insert, self.cls.sketch_merge = self._saved


def _recording_channel(channel, log):
    """``channel`` that appends ``(kind, bytes, seconds, answer)`` of each push
    to ``log``; the kind read from the header near the blob's start."""

    def push(blob):
        t0 = time.perf_counter()
        answer = channel(blob)
        kind = "delta" if blob.find(b"delta-v1", 0, 2048) >= 0 else ("int8" if blob.find(b"int8-zlib-v1", 0, 2048) >= 0 else "full")
        log.append((kind, len(blob), time.perf_counter() - t0, answer, blob))
        return answer

    return push


def phase_fleet(preds, target):
    """fleet_path: the served ImageNet epoch over four hosts, two pods and a
    global aggregator, each behind its own FleetServer on 127.0.0.1."""
    import urllib.error

    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch import fleet
    from metrics_tpu_torch.fleet import wire
    from metrics_tpu_torch.obs import runtime_metrics as rm
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.ops import compactor as k3
    from metrics_tpu_torch.resilience.health import registry as health

    dev = preds.device
    plan = serve_plan(ROWS, SEED + 11)
    rm.registry.reset()
    health.clear()
    proto = _fleet_proto(mtt, dev)
    knobs = {"publish_every_s": FLEET_PUBLISH_EVERY_S, "stale_after_s": FLEET_STALE_AFTER_S, "deadline_s": 30.0}
    glob = fleet.Aggregator(proto, node_id="global", stale_after_s=FLEET_STALE_AFTER_S)
    pods = [fleet.Aggregator(proto, node_id=f"pod-{p}", stale_after_s=FLEET_STALE_AFTER_S) for p in range(FLEET_PODS)]
    servers = [fleet.FleetServer(a) for a in [glob] + pods]
    host_log, pod_log = [], []
    loops, host_pubs, pod_pubs = [], [], []
    _reset_kernel_counts()
    try:
        with _CountedSketch() as counted:
            for p, pod in enumerate(pods):
                pod_pubs.append(fleet.FleetPublisher(pod, _recording_channel(servers[0].channel(), pod_log), host_id=pod.node_id, delta=True, **knobs))
            for h in range(FLEET_HOSTS):
                loop = mtt.ServeLoop(proto, workers=1, queue_size=len(plan) + 1, reduce_every_s=FLEET_REDUCE_EVERY_S)
                loops.append(loop)
                host_pubs.append(fleet.FleetPublisher(loop, _recording_channel(servers[1 + h % FLEET_PODS].channel(), host_log),
                                                      host_id=f"host-{h}", delta=True, **knobs))
            accepted = [[] for _ in loops]
            t_serve = time.perf_counter()
            for i, (off, n) in enumerate(plan):
                h = i % FLEET_HOSTS
                if loops[h].offer(preds[off:off + n], target[off:off + n]):
                    accepted[h].append((off, n))
            for loop in loops:
                if not loop.drain(300):
                    raise AssertionError("fleet_path: a host did not drain")
            t_drained = time.perf_counter()
            served_rows = sum(n for a in accepted for _, n in a)
            bap_updates = sum(_coll_members(r)["bap"].update_count for loop in loops for r in loop._replicas)
            q_updates = sum(_coll_members(r)["q"].update_count for loop in loops for r in loop._replicas)
            want_updates = sum(len(a) for a in accepted) * len(_coll_members(proto))
            # the time from the last request to a global report that holds it
            while True:
                rep = glob.report()
                if rep["updates"] == want_updates:
                    break
                if time.perf_counter() - t_drained > 60:
                    raise AssertionError(f"fleet_path: the global report holds {rep['updates']} of {want_updates} updates after 60 s")
                time.sleep(0.005)
            freshness_s = time.perf_counter() - t_drained
            serve_s = t_drained - t_serve
            # a publish after a reduce reads the reporter back; one between
            # two reduces reuses that read
            fresh_reads = blocking_reads(lambda i: loops[0]._last_reporter.snapshot_state(), 1)
            loops[0].fleet_view()
            cached_reads = blocking_reads(lambda i: loops[0].fleet_view(), 3)
            glob._fold_cache = None
            _, fold_s = _timed(glob._fold)
            reporter = glob._fold()
            # a host whose publisher stops is named stale in the global scrape
            stopped = FLEET_HOSTS - 1
            host_pubs[stopped].stop(flush=True)
            t_stop, t_stop_mono = time.perf_counter(), time.monotonic()
            key = f'metrics_tpu_fleet_host_stale{{host="host-{stopped}",node="global",via="pod-{stopped % FLEET_PODS}"}}'
            while _scrape_values(glob.scrape()).get(key) != 1.0:
                if time.perf_counter() - t_stop > FLEET_STALE_AFTER_S + FLEET_STALE_SLACK_S:
                    raise AssertionError(f"fleet_path: the global scrape does not name host-{stopped} stale {FLEET_STALE_AFTER_S + FLEET_STALE_SLACK_S} s after its publisher stopped")
                time.sleep(0.02)
            stale_s = time.perf_counter() - t_stop
            at_global = [e for e in health.events("fleet_host_stale")
                         if e["details"].get("host") == f"host-{stopped}" and e["details"].get("node_id") == "global"]
            stale_events = [e for e in at_global if e["time_mono"] >= t_stop_mono]
            for pub in host_pubs + pod_pubs:
                pub.stop(flush=False)
            for loop in loops:
                loop.stop()
            text = glob.scrape()
            hist_folds = sum(h.folds for h in rm.registry.histograms().values())
        k1_launches, k3_launches = k1.launch_count, k3.launch_count

        # a re-delivered blob answers duplicate; a flipped byte is refused naming host and leaf
        kind, _, _, _, last = next(x for x in reversed(host_log) if x[0] == "full")
        again = servers[1].channel()(last) if wire.decode_view(last)[0]["host_id"] in ("host-0", "host-2") else servers[2].channel()(last)
        if not again.startswith(b"duplicate:"):
            raise AssertionError(f"fleet_path: a re-delivered view answered {again!r}")
        host0 = next(x[4] for x in reversed(host_log) if wire.decode_view(x[4])[0]["host_id"] == "host-0" and x[0] == "full")
        try:
            servers[1].channel()(host0[:-64] + bytes([host0[-64] ^ 1]) + host0[-63:])
            raise AssertionError("fleet_path: a bit-flipped view was accepted")
        except urllib.error.HTTPError as err:
            body = err.read().decode()
            if err.code != 400 or "host-0" not in body or "leaf" not in body:
                raise AssertionError(f"fleet_path: a bit-flipped view answered {err.code} {body!r}")

        # the global view against one process over the whole epoch
        ref = eager_twin(build_compiled(mtt, dev))
        for a in accepted:
            for off, n in a:
                ref.update(preds[off:off + n], target[off:off + n])
        fold_members = _coll_members(reporter)
        states_bit_equal(mtt.MetricCollection({k: fold_members[k] for k in ("acc1", "acc5", "bap")}), ref,
                         "fleet_path: the global view against one process over the epoch")
        # the sketch: an in-process sketch_merge fold of the hosts' views in the aggregators' order
        host_q = [_coll_members(loop._last_reporter)["q"].sketch for loop in loops]
        empty = _coll_members(proto)["q"].sketch
        pod_q = []
        for p in range(FLEET_PODS):
            s = empty
            for h in sorted(range(FLEET_HOSTS), key=lambda h: f"host-{h}"):
                if h % FLEET_PODS == p:
                    s = s.sketch_merge(host_q[h])
            pod_q.append(s)
        want_q = empty
        for s in pod_q:
            want_q = want_q.sketch_merge(s)
        got_q = fold_members["q"].sketch
        for field in ("items", "counts", "n_seen"):
            if not torch.equal(getattr(got_q, field), getattr(want_q, field)):
                raise AssertionError(f"fleet_path: the global sketch's {field} differs from the in-process fold")
        conf = torch.cat([preds[off:off + n].max(dim=1).values for a in accepted for off, n in a]).sort().values.cpu().numpy()
        qv = fold_members["q"].compute().cpu().numpy()
        rank_err = {f"{q:g}": abs(int(np.searchsorted(conf, v, side="right")) - q * conf.size) / conf.size
                    for q, v in zip(fold_members["q"].quantiles, qv)}
        if max(rank_err.values()) > FLEET_EPS:
            raise AssertionError(f"fleet_path: quantile rank errors {rank_err} above eps {FLEET_EPS}")

        # one pass with int8 views: counts exact, the sketch within the codec
        int8_log = []
        g8 = fleet.Aggregator(proto, node_id="global")
        p8 = [fleet.Aggregator(proto, node_id=f"pod-{p}") for p in range(FLEET_PODS)]
        for h, loop in enumerate(loops):
            fleet.FleetPublisher(loop, _recording_channel(p8[h % FLEET_PODS].ingest, int8_log), host_id=f"host-{h}",
                                 encoding="int8", start=False).publish_now()
        for pod in p8:
            g8.ingest(pod.view_blob())
        f8 = _coll_members(g8._fold())
        ref_members = _coll_members(ref)
        states_bit_equal(mtt.MetricCollection({k: f8[k] for k in ("acc1", "acc5")}), mtt.MetricCollection({k: ref_members[k] for k in ("acc1", "acc5")}),
                         "fleet_path: the int8 global view's counts")
        # BAP's float32 counters ride the codec: each host's lane within its block's absmax / 252
        int8_err = {k: float((getattr(f8["bap"], k) - getattr(ref_members["bap"], k)).abs().max()) for k in ("TPs", "FPs", "FNs")}
        int8_bound = {k: FLEET_HOSTS * float(getattr(ref_members["bap"], k).abs().max()) / 252 for k in int8_err}
        if any(int8_err[k] > int8_bound[k] for k in int8_err):
            raise AssertionError(f"fleet_path: int8 BAP counters off by {int8_err}, bound {int8_bound}")
        qv8 = f8["q"].compute().cpu().numpy()
        rank_err8 = {f"{q:g}": abs(int(np.searchsorted(conf, v, side="right")) - q * conf.size) / conf.size
                     for q, v in zip(f8["q"].quantiles, qv8)}
        if max(rank_err8.values()) > 2 * FLEET_EPS:
            raise AssertionError(f"fleet_path: int8 quantile rank errors {rank_err8}")
    finally:
        for pub in host_pubs + pod_pubs:
            pub.stop(flush=False)
        for loop in loops:
            loop.stop()
        for s in servers:
            s.close()
    merges = counted.merges
    if k1_launches != bap_updates or bap_updates != sum(len(a) for a in accepted):
        raise AssertionError(f"fleet_path: K1 {k1_launches} launches, {bap_updates} BAP updates, {sum(len(a) for a in accepted)} requests")
    # K3: one launch per insert (the hosts' sketch updates and the telemetry
    # histograms' folds) and per merge (the hosts' reduces, the aggregators' folds)
    if k3_launches != counted.inserts + sum(merges.values()) or counted.inserts != q_updates + hist_folds:
        raise AssertionError(f"fleet_path: K3 {k3_launches} launches; {counted.inserts} inserts ({q_updates} sketch updates, "
                             f"{hist_folds} telemetry folds), merges {merges}")
    if len(stale_events) != 1:
        raise AssertionError(f"fleet_path: {len(stale_events)} fleet_host_stale events at the global for host-{stopped}: "
                             f"{[e['message'] for e in stale_events]}")
    by_kind = {}
    for kind, size, dt, _, _ in host_log:
        by_kind.setdefault(kind, []).append((size, dt))
    if "delta" not in by_kind or "full" not in by_kind:
        raise AssertionError(f"fleet_path: hosts shipped {sorted(by_kind)} views, expected full and delta")
    emit({
        "phase": "fleet_path",
        "config": {"rows": ROWS, "classes": CLASSES, "hosts": FLEET_HOSTS, "pods": FLEET_PODS, "workers_per_host": 1,
                   "requests": len(plan), "collection": "{acc1, acc5, bap, q: QuantileSketch(top-1 confidence)}",
                   "transport": "HTTP on 127.0.0.1, one FleetServer per aggregator", "delta": True,
                   "publish_every_s": FLEET_PUBLISH_EVERY_S, "reduce_every_s": FLEET_REDUCE_EVERY_S,
                   "stale_after_s": FLEET_STALE_AFTER_S, "sketch_eps": FLEET_EPS},
        "served_rows": served_rows,
        "serve_s": serve_s,
        "rows_per_s": served_rows / serve_s,
        "view_bytes": {k: {"p50": float(np.median([s for s, _ in v])), "publishes": len(v)} for k, v in by_kind.items()},
        "int8_view_bytes_p50": float(np.median([s for _, s, _, _, _ in int8_log])),
        "publish_ms": {"p50": _p([dt for _, _, dt, _, _ in host_log], 50), "p99": _p([dt for _, _, dt, _, _ in host_log], 99)},
        "pod_publish_ms_p50": _p([dt for _, _, dt, _, _ in pod_log], 50),
        "global_fold_ms": fold_s * 1e3,
        "last_request_to_global_report_s": freshness_s,
        "blocking_reads_per_publish": {"after_a_reduce": len(fresh_reads), "between_reduces": len(cached_reads) / 3},
        "stale_named_after_s": stale_s,
        "stale_events_at_global_before_stop": len(at_global) - len(stale_events),
        "quantile_rank_err": rank_err,
        "int8_quantile_rank_err": rank_err8,
        "int8_bap_max_abs_err": int8_err, "int8_bap_bound": int8_bound,
        "duplicate_answer": again.decode(),
        "k1_launches": k1_launches, "bap_updates": bap_updates,
        "k3_launches": k3_launches,
        "k3_predicted": {"sketch_updates": q_updates, "telemetry_folds": hist_folds, "merges": merges},
        "global_bit_equal_one_process": True,
        "scrape_lines": len(text.splitlines()),
    })
    return k1_launches, k3_launches


# -- the detection slice (phase 36) -------------------------------------------


def coco_val(n_images, seed=COCO_SEED):
    """A COCO val2017-shaped detection set on the host: the first
    ``n_images`` of 5,000 images (640x480 and 480x640 alternately), with
    the 36,781 ground-truth boxes over 80 classes (class frequencies
    Zipf-like, as COCO's) drawn among all 5,000, COCO's shares of small,
    medium and large objects (about 41/34/24 %), and 100 detections an
    image: two jittered copies of each ground truth (5 % with another label)
    and false positives, half of them labelled with a class of the image,
    with seeded scores. All 5,000 images are drawn at once, so the first
    ``n`` are the same whatever ``n``. Returns ``(preds, targets, shapes)``:
    per-image dicts of numpy arrays (boxes in xyxy) and each image's
    ``(h, w)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = COCO_IMAGES
    counts = rng.multinomial(COCO_GT_BOXES, np.full(n, 1.0 / n))
    class_p = 1.0 / np.arange(1, COCO_CLASSES + 1)
    class_p /= class_p.sum()
    bounds = np.array([16.0, 32.0 ** 2, 96.0 ** 2, 640.0 * 480.0 * 0.6])
    heights, widths = np.where(np.arange(n) % 2 == 0, 480, 640), np.where(np.arange(n) % 2 == 0, 640, 480)

    def boxes(img):
        """Boxes of the images ``img`` (one a row), sized by COCO's shares."""
        h, w = heights[img].astype(np.float64), widths[img].astype(np.float64)
        sizes = rng.choice(3, img.size, p=COCO_AREA_SHARES)
        area = np.exp(rng.uniform(np.log(bounds[sizes]), np.log(bounds[sizes + 1])))
        ratio = np.exp(rng.uniform(np.log(0.5), np.log(2.0), img.size))
        bw, bh = np.minimum(np.sqrt(area * ratio), w - 1.0), np.minimum(np.sqrt(area / ratio), h - 1.0)
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        return np.stack([x1, y1, x1 + bw, y1 + bh], axis=1).astype(np.float32)

    def ranks(c):
        return np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)

    gt_img = np.repeat(np.arange(n), counts)
    gt = boxes(gt_img)
    gt_labels = rng.choice(COCO_CLASSES, gt_img.size, p=class_p)
    gt_start = np.cumsum(counts) - counts
    # two jittered copies of each ground truth, at most COCO_DETS an image
    copies = np.minimum(2 * counts, COCO_DETS)
    cp_img = np.repeat(np.arange(n), copies)
    src = gt_start[cp_img] + ranks(copies) // 2
    side = np.repeat(gt[src, 2:] - gt[src, :2], 2, axis=1)
    limit = np.stack([widths[cp_img], heights[cp_img], widths[cp_img], heights[cp_img]], axis=1)
    det = np.clip(gt[src] + (rng.normal(0.0, 0.06, (src.size, 4)) * side).astype(np.float32), 0, limit).astype(np.float32)
    det_labels = gt_labels[src].copy()
    swap = rng.random(src.size) < 0.05
    det_labels[swap] = rng.choice(COCO_CLASSES, int(swap.sum()), p=class_p)
    det_scores = rng.beta(5.0, 2.0, src.size)
    # false positives to COCO_DETS an image, half with a class of the image
    fps = COCO_DETS - copies
    fp_img = np.repeat(np.arange(n), fps)
    fp = boxes(fp_img)
    fp_labels = rng.choice(COCO_CLASSES, fp_img.size, p=class_p)
    own = (rng.random(fp_img.size) < 0.5) & (counts[fp_img] > 0)
    pick = np.floor(rng.random(int(own.sum())) * counts[fp_img[own]]).astype(np.int64)
    fp_labels[own] = gt_labels[gt_start[fp_img[own]] + pick]
    fp_scores = rng.beta(1.5, 5.0, fp_img.size)

    split = lambda a, c: np.split(a, np.cumsum(c)[:-1])  # noqa: E731
    parts = zip(split(det, copies), split(det_labels, copies), split(det_scores, copies), split(fp, fps), split(fp_labels, fps),
                split(fp_scores, fps), split(gt, counts), split(gt_labels, counts))
    preds, targets, shapes = [], [], []
    for i, (d, dl, ds, f, fl, fs, g, gl) in zip(range(n_images), parts):
        preds.append({"boxes": np.concatenate([d, f]), "scores": np.concatenate([ds, fs]).astype(np.float32),
                      "labels": np.concatenate([dl, fl])})
        targets.append({"boxes": g, "labels": gl})
        shapes.append((int(heights[i]), int(widths[i])))
    return preds, targets, shapes


def _box_masks(boxes, h, w, dev):
    """``(n, h, w)`` bool masks filled inside each box (at least one pixel),
    made on ``dev`` as a segmentation head's output lies there."""
    import torch

    b = torch.as_tensor(boxes, device=dev)
    x1, y1 = b[:, 0].floor().clamp(max=w - 1), b[:, 1].floor().clamp(max=h - 1)
    x2, y2 = torch.maximum(b[:, 2].ceil(), x1 + 1), torch.maximum(b[:, 3].ceil(), y1 + 1)
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    cols = (xs[None, :] >= x1[:, None]) & (xs[None, :] < x2[:, None])
    rows = (ys[None, :] >= y1[:, None]) & (ys[None, :] < y2[:, None])
    return rows[:, :, None] & cols[:, None, :]


def _segm_items(preds, targets, shapes, dev):
    out_p, out_t = [], []
    for p, t, (h, w) in zip(preds, targets, shapes):
        out_p.append({"masks": _box_masks(p["boxes"], h, w, dev), "scores": p["scores"], "labels": p["labels"]})
        out_t.append({"masks": _box_masks(t["boxes"], h, w, dev), "labels": t["labels"]})
    return out_p, out_t


def _map_values(values):
    """A ``MeanAveragePrecision`` output as lists of floats (exact)."""
    return {k: v.detach().cpu().reshape(-1).tolist() for k, v in values.items()}


def _map_run(mtt, dev, preds, targets, iou_type="bbox", timings=None):
    """``MeanAveragePrecision(class_metrics=True)`` fed ``COCO_UPDATE_IMAGES``
    images an update; its values, and the update seconds in ``timings``."""
    import torch

    m = mtt.detection.MeanAveragePrecision(iou_type=iou_type, class_metrics=True, device=dev)
    for s in range(0, len(preds), COCO_UPDATE_IMAGES):
        t0 = time.perf_counter()
        m.update(preds[s:s + COCO_UPDATE_IMAGES], targets[s:s + COCO_UPDATE_IMAGES])
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            timings.append(time.perf_counter() - t0)
    return m


def _greedy_cell(ious, gt_ig, thrs):
    """pycocotools' ``evaluateImg`` for one cell and area range, every
    threshold at once: ground truths ordered non-ignored first, each
    detection (score order) walks them, skipping a taken gt, stopping at the
    ignored gts once it holds a non-ignored one, and taking a gt at or above
    the best IoU so far (from ``min(t, 1 - 1e-10)``), so a later gt wins a
    tie."""
    import numpy as np

    nd, ng = ious.shape
    nt = len(thrs)
    order = np.argsort(gt_ig, kind="mergesort")
    dtm = np.zeros((nt, nd), bool)
    dtig = np.zeros((nt, nd), bool)
    gtm = np.zeros((nt, ng), bool)
    for d in range(nd):
        best = np.minimum(thrs.astype(np.float64), 1 - 1e-10)
        m = np.full(nt, -1)
        stopped = np.zeros(nt, bool)
        for g in order:
            free = ~gtm[:, g]
            stopped |= free & (m > -1) & ~gt_ig[np.maximum(m, 0)] & gt_ig[g]
            take = free & ~stopped & ~(ious[d, g] < best)
            best = np.where(take, ious[d, g], best)
            m = np.where(take, g, m)
        hit = np.flatnonzero(m > -1)
        dtm[hit, d], dtig[hit, d], gtm[hit, m[hit]] = True, gt_ig[m[hit]], True
    return dtm, dtig


def _host_box_iou(det, gt):
    """float32 IoUs on the host in the port's order of operations."""
    import numpy as np

    a1 = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    a2 = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.maximum(rb - lt, np.float32(0))
    inter = wh[..., 0] * wh[..., 1]
    union = a1[:, None] + a2[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, np.float32(0)).astype(np.float32)


def _matcher_steps(m):
    """The matcher's steps (detection-axis iterations, summed over its
    batches) in one ``compute()`` of ``m``: each bucket of cells (a
    power-of-two detection cap, at least 8) in batches of up to
    ``_MATCH_CHUNK`` cells, each batch a step per detection slot."""
    from metrics_tpu_torch.detection.matcher import next_pow2

    images = m._host_images()
    cells = m._build_cells(m._get_classes(images), m.max_detection_thresholds[-1], images)
    buckets = {}
    for nd in cells["nd"].tolist():
        cap = max(next_pow2(nd), 8)
        buckets[cap] = buckets.get(cap, 0) + 1
    return sum(-(-n // min(m._MATCH_CHUNK, next_pow2(n))) * cap for cap, n in buckets.items())


def check_greedy_cells(mtt, dev, preds, targets):
    """The card matcher's matches on every cell of the images against the
    plain per-cell loop in pycocotools' order; returns the cells checked,
    the matching's kernel launches (a profiler window) and its steps."""
    import numpy as np

    m = _map_run(mtt, dev, preds, targets)
    images = m._host_images()
    area_ranges = np.asarray(list(m.bbox_area_ranges.values()), np.float64)
    cells = m._build_cells(m._get_classes(images), m.max_detection_thresholds[-1], images)
    out = {}
    launches = _host_launches(lambda: out.update(r=m._match_all_cells(cells, area_ranges, images)))
    matches, ignored, gt_ig = out["r"]
    thrs = np.asarray(m.iou_thresholds, np.float32)
    det, gt = images["det"][cells["det_idx"]], images["gt"][cells["gt_idx"]]
    for j, (nd, ng, ds, gs) in enumerate(zip(cells["nd"], cells["ng"], cells["det_start"], cells["gt_start"])):
        if not nd:
            continue
        ious = _host_box_iou(det[ds:ds + nd], gt[gs:gs + ng]) if ng else np.zeros((nd, 0), np.float32)
        for a in range(area_ranges.shape[0]):
            dtm, dtig = _greedy_cell(ious, gt_ig[a, gs:gs + ng], thrs)
            if not (np.array_equal(matches[a, :, ds:ds + nd], dtm) and np.array_equal(ignored[a, :, ds:ds + nd], dtig)):
                raise AssertionError(f"detection_path: cell {j} area {a}: the card's matches differ from the per-cell greedy loop")
    return int(cells["nd"].size), launches, _matcher_steps(m)


def detection_world(mtt, dist, dev, rank, world, sync):
    """F12 on the card, in the fused evaluation's world: each rank updates
    its contiguous share of the first ``COCO_CPU_IMAGES`` images and
    ``compute()`` syncs them; the parent holds the values against one
    process over the same images (``phase_detection``)."""
    t0 = time.perf_counter()
    preds, targets, _ = coco_val(COCO_CPU_IMAGES)
    share = -(-COCO_CPU_IMAGES // world)
    lo, hi = rank * share, min((rank + 1) * share, COCO_CPU_IMAGES)
    m = _map_run(mtt, dev, preds[lo:hi], targets[lo:hi])
    sync()
    dist.barrier()
    with CollectiveRecorder() as rec:
        values = m.compute()
        sync()
    return {"detection": {"values": _map_values(values), "images": hi - lo, "all_reduce": rec.all_reduce, "other": rec.other,
                          "local_images": len(m.image_sizes), "s": time.perf_counter() - t0}}


# the fused evaluation world's MeanAveragePrecision results, held against
# the one-process values in phase_detection
_DETECTION_WORLD = []


def phase_detection(dev):
    """detection_path: a COCO val2017-shaped bbox evaluation on the card, a
    segm run on 128 of its images, their CPU runs, the per-cell greedy
    check and F12 in the four-rank world."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.obs import trace as tr

    _reset_kernel_counts()
    cpu = torch.device("cpu")
    t_data = time.perf_counter()
    preds, targets, shapes = coco_val(COCO_IMAGES)
    data_s = time.perf_counter() - t_data
    n_gt = sum(int(t["labels"].size) for t in targets)
    gt_areas = np.concatenate([(t["boxes"][:, 2] - t["boxes"][:, 0]) * (t["boxes"][:, 3] - t["boxes"][:, 1]) for t in targets])
    area_shares = [float(np.mean(gt_areas < 32 ** 2)), float(np.mean((gt_areas >= 32 ** 2) & (gt_areas < 96 ** 2))), float(np.mean(gt_areas >= 96 ** 2))]
    if n_gt != COCO_GT_BOXES or any(len(p["labels"]) != COCO_DETS for p in preds):
        raise AssertionError(f"detection_path: {n_gt} ground truths, detections per image {set(len(p['labels']) for p in preds)}")

    # the bbox evaluation of all 5,000 images on the card
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    update_s = []
    t0 = time.perf_counter()
    card = _map_run(mtt, dev, preds, targets, timings=update_s)
    feed_s = time.perf_counter() - t0
    tr.clear_trace()
    with tr.force_tracing(True):
        (values, compute_s) = _timed(card.compute)
        spans = {name: sum(r.dur_ns for r in tr.trace_records(name)) / 1e9
                 for name in ("detection.build_cells", "detection.match", "detection.accumulate")}
    peak_mem = torch.cuda.max_memory_allocated() - base_mem
    full = _map_values(values)
    for k, v in full.items():
        if not all(math.isfinite(x) for x in v):
            raise AssertionError(f"detection_path: {k} is not finite: {v[:4]}")
    if not 0.0 < full["map"][0] < 1.0 or len(full["map_per_class"]) != COCO_CLASSES:
        raise AssertionError(f"detection_path: map {full['map']}, {len(full['map_per_class'])} classes")
    full_steps = _matcher_steps(card)
    split = {"data": data_s, "feed": feed_s, "compute": compute_s}

    # the first COCO_CPU_IMAGES images: the card against the port on the CPU,
    # and the matcher's launches in a profiler window over the card's matching
    t1 = time.perf_counter()
    sub_card = _map_values(_map_run(mtt, dev, preds[:COCO_CPU_IMAGES], targets[:COCO_CPU_IMAGES]).compute())
    split["card_500"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    sub_cpu = _map_values(_map_run(mtt, cpu, preds[:COCO_CPU_IMAGES], targets[:COCO_CPU_IMAGES]).compute())
    cpu_s = split["cpu_500"] = time.perf_counter() - t1
    if sub_card != sub_cpu:
        bad = [k for k in sub_card if sub_card[k] != sub_cpu[k]]
        raise AssertionError(f"detection_path: the card's bbox outputs {bad} differ from the CPU run over {COCO_CPU_IMAGES} images")
    t1 = time.perf_counter()
    cells_checked, match_launches, sub_steps = check_greedy_cells(mtt, dev, preds[:COCO_GREEDY_IMAGES], targets[:COCO_GREEDY_IMAGES])
    split["greedy_check"] = time.perf_counter() - t1

    # F12 in the four-rank world of the fused evaluation path
    if len(_DETECTION_WORLD) != DIST_WORLD:
        raise AssertionError(f"detection_path: {len(_DETECTION_WORLD)} ranks reported the synced MeanAveragePrecision")
    for rank, r in enumerate(_DETECTION_WORLD):
        if r["values"] != sub_card or r["other"] != ["all_gather"] * 12 or r["all_reduce"]:
            raise AssertionError(f"detection_path: rank {rank}'s synced values {'differ' if r['values'] != sub_card else 'agree'}, "
                                 f"collectives {r['all_reduce']} {r['other']}")
    world_s = max(r["s"] for r in _DETECTION_WORLD)

    # segm on COCO_SEGM_IMAGES images, masks on the card
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    sp, st = _segm_items(preds[:COCO_SEGM_IMAGES], targets[:COCO_SEGM_IMAGES], shapes[:COCO_SEGM_IMAGES], dev)
    segm_update_s = []
    segm = _map_run(mtt, dev, sp, st, iou_type="segm", timings=segm_update_s)
    segm_values, segm_compute_s = _timed(lambda: _map_values(segm.compute()))
    segm_peak = torch.cuda.max_memory_allocated() - base_mem
    if not 0.0 < segm_values["map"][0] < 1.0:
        raise AssertionError(f"detection_path: segm map {segm_values['map']}")
    del segm
    split["segm"] = time.perf_counter() - t1
    n = COCO_SEGM_CPU_IMAGES
    t1 = time.perf_counter()
    segm_card = _map_values(_map_run(mtt, dev, sp[:n], st[:n], iou_type="segm").compute())
    to_cpu = lambda items: [{k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in d.items()} for d in items]  # noqa: E731
    segm_cpu = _map_values(_map_run(mtt, cpu, to_cpu(sp[:n]), to_cpu(st[:n]), iou_type="segm").compute())
    split["segm_card_and_cpu_16"] = time.perf_counter() - t1
    if segm_card != segm_cpu:
        bad = [k for k in segm_card if segm_card[k] != segm_cpu[k]]
        raise AssertionError(f"detection_path: the card's segm outputs {bad} differ from the CPU run over {n} images")
    del sp, st
    torch.cuda.empty_cache()
    counts = _check_no_kernel_launched("detection_path")
    SLICE_PHASE_S["detection_path_world_ranks"] = world_s
    emit({
        "phase": "detection_path",
        "config": {"images": COCO_IMAGES, "gt_boxes": n_gt, "classes": COCO_CLASSES, "detections_per_image": COCO_DETS,
                   "sizes": "640x480 and 480x640 alternately", "gt_area_shares_small_medium_large": area_shares,
                   "images_per_update": COCO_UPDATE_IMAGES, "class_metrics": True, "seed": COCO_SEED,
                   "segm_images": COCO_SEGM_IMAGES, "segm_cut": "from 5,000 images: 100 masks of 307,200 pixels are 31 MB an image",
                   "cpu_check_images": {"bbox": COCO_CPU_IMAGES, "segm": n}, "greedy_check_images": COCO_GREEDY_IMAGES},
        "data_s": data_s,
        "update_ms": {"p50": _p(update_s, 50), "p99": _p(update_s, 99)},
        "images_per_s": COCO_IMAGES / feed_s,
        "compute_s": compute_s,
        "compute_split_s": {"build_cells": spans["detection.build_cells"], "match_on_card": spans["detection.match"],
                            "accumulate": spans["detection.accumulate"]},
        "matcher_launches": {"images": COCO_GREEDY_IMAGES, "launches": match_launches, "steps": sub_steps,
                             "launches_per_step": match_launches / sub_steps, "steps_of_the_5000_image_compute": full_steps},
        "phase_split_s": split,
        "peak_device_bytes": peak_mem,
        "map": full["map"][0], "map_50": full["map_50"][0], "map_75": full["map_75"][0], "map_small": full["map_small"][0],
        "map_medium": full["map_medium"][0], "map_large": full["map_large"][0], "mar_100": full["mar_100"][0],
        "cpu_check": {"images": COCO_CPU_IMAGES, "equal": True, "cpu_s": cpu_s},
        "greedy_cells_checked": cells_checked,
        "f12_world": {"ranks": DIST_WORLD, "images": [r["images"] for r in _DETECTION_WORLD], "equal_one_process": True,
                      "collectives_per_rank": len(_DETECTION_WORLD[0]["other"]), "slowest_rank_s": world_s},
        "segm": {"update_ms_p50": _p(segm_update_s, 50), "compute_s": segm_compute_s, "peak_device_bytes": segm_peak,
                 "map": segm_values["map"][0], "cpu_check_images": n, "equal": True},
        "kernel_launches": counts,
    })
    return counts


# -- the audio slice (phases 37-38) --------------------------------------------


def wsj0_2mix_plan(seed=WSJ_SEED):
    """The seeded shape of WSJ0-2mix's test split: each mixture's length in
    samples (rounded to WSJ_ROUND_S), the second speaker's level against the
    first (dB), each estimate's planted SI-SDR (dB) and the order in which
    the two estimates come out (1: swapped)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi, mean, spread = WSJ_SECONDS
    seconds = np.clip(rng.normal(mean, spread, WSJ_MIXTURES), lo, hi)
    seconds = np.round(seconds / WSJ_ROUND_S) * WSJ_ROUND_S
    return {
        "samples": (seconds * WSJ_FS).astype(np.int64),
        "levels_db": rng.uniform(-WSJ_LEVELS_DB, WSJ_LEVELS_DB, WSJ_MIXTURES),
        "si_sdr_db": rng.uniform(*WSJ_SI_SDR_DB, size=(WSJ_MIXTURES, 2)),
        "swapped": rng.integers(0, 2, WSJ_MIXTURES),
    }


def wsj0_2mix_batch(plan, index, dev, seed=WSJ_SEED):
    """The sources and the PIT-shuffled estimates of the mixtures ``index``
    (one length), made on the card from a seed of their own: harmonic
    voices (f0 90-250 Hz, ten harmonics with a slow vibrato) under a
    syllable envelope of 2.5-5 Hz (valleys 16 dB down), with pauses (a gate
    of 0.2-0.4 Hz, opening voiced, that puts about a quarter of a long clip
    80 dB down, which the VAD removes) and a little breath noise; each
    source at unit RMS times its mixing level.
    Each estimate is its source plus the other speaker and white noise at
    its planted SI-SDR (half the distortion energy each), and the two
    estimates come out in the plan's order."""
    import torch

    n, length = len(index), int(plan["samples"][index[0]])
    g = torch.Generator(device=dev).manual_seed(seed * 100_003 + int(index[0]))
    t = torch.arange(length, device=dev, dtype=torch.float32) / WSJ_FS

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, 1, generator=g, device=dev)

    f0, vib = u(90.0, 250.0, n, 2), u(0.0, 6.283, n, 2)
    inst = 2 * math.pi * f0 * (t + 0.01 * torch.sin(2 * math.pi * 0.7 * t + vib))
    voice = torch.zeros(n, 2, length, device=dev)
    for k in range(1, 11):
        voice += torch.sin(k * inst + u(0.0, 6.283, n, 2)) / k
    syllables = 0.15 + 0.85 * torch.relu(torch.sin(2 * math.pi * u(2.5, 5.0, n, 2) * t + u(0.0, 6.283, n, 2))) ** 2
    gate = torch.sigmoid(40.0 * (torch.sin(2 * math.pi * u(0.2, 0.4, n, 2) * t + u(0.0, 1.571, n, 2)) + 0.6))
    src = (voice * syllables + 0.05 * syllables * torch.randn(n, 2, length, generator=g, device=dev)) * (gate + 1e-4)
    src = src / src.pow(2).mean(-1, keepdim=True).sqrt()
    level = torch.as_tensor(plan["levels_db"][index], device=dev, dtype=torch.float32)
    src[:, 1] *= (10.0 ** (level / 20.0))[:, None]
    energy = src.pow(2).sum(-1, keepdim=True)
    distortion = energy / 10.0 ** (torch.as_tensor(plan["si_sdr_db"][index], device=dev, dtype=torch.float32)[..., None] / 10.0)
    other = src.flip(1)
    noise = torch.randn(n, 2, length, generator=g, device=dev)
    est = src + other * (distortion / 2 / other.pow(2).sum(-1, keepdim=True)).sqrt() + noise * (distortion / 2 / length).sqrt()
    swapped = torch.as_tensor(plan["swapped"][index], device=dev).bool()
    shuffled = torch.where(swapped[:, None, None], est.flip(1), est)
    return src, shuffled


def wsj0_2mix_batches(plan):
    """Each length's mixtures in batches of at most WSJ_BATCH, in the order
    of the lengths."""
    import numpy as np

    out = []
    for length in np.unique(plan["samples"]):
        idx = np.flatnonzero(plan["samples"] == length)
        out.extend(idx[i:i + WSJ_BATCH] for i in range(0, idx.size, WSJ_BATCH))
    return out


def _audio_metrics(mtt, dev):
    from metrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio

    return {
        "si_sdr": mtt.ScaleInvariantSignalDistortionRatio(device=dev),
        "sdr": mtt.SignalDistortionRatio(device=dev),
        "sdr_cg": mtt.SignalDistortionRatio(use_cg_iter=WSJ_CG_ITER, device=dev),
        "snr": mtt.SignalNoiseRatio(device=dev),
        "si_snr": mtt.ScaleInvariantSignalNoiseRatio(device=dev),
        "pit": mtt.PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, device=dev),
        "stoi": mtt.ShortTimeObjectiveIntelligibility(WSJ_FS, use_device_implementation=True, device=dev),
        "estoi": mtt.ShortTimeObjectiveIntelligibility(WSJ_FS, extended=True, use_device_implementation=True, device=dev),
    }


def _audio_values(src, shuffled, dev):
    """Each clip's value of every audio metric through the port's functions on
    ``dev`` (the permutation found by PIT, then the aligned estimates)."""
    import metrics_tpu_torch.functional.audio as F

    src, shuffled = src.to(dev), shuffled.to(dev)
    best, perm = F.permutation_invariant_training(shuffled, src, F.scale_invariant_signal_distortion_ratio)
    aligned = F.pit_permutate(shuffled, perm)
    return {"perm": perm, "pit": best, "si_sdr": F.scale_invariant_signal_distortion_ratio(aligned, src),
            "sdr": F.signal_distortion_ratio(aligned, src), "sdr_cg": F.signal_distortion_ratio(aligned, src, use_cg_iter=WSJ_CG_ITER),
            "snr": F.signal_noise_ratio(aligned, src), "si_snr": F.scale_invariant_signal_noise_ratio(aligned, src),
            "stoi": F.stoi_on_device(aligned, src, fs=WSJ_FS, device=dev),
            "estoi": F.stoi_on_device(aligned, src, fs=WSJ_FS, extended=True, device=dev)}


def _card_kernels(fns):
    """Kernels and copies the card runs in one call of each of ``fns``
    (``{name: fn}``), in one profiler window: each call is labelled and
    ends in a synchronize, so the card's records that start inside its
    label are its own (a replayed graph's kernels are counted one by one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in fns.items():
            with record_function(f"audio_call.{name}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    spans = {e.name[len("audio_call."):]: e.time_range for e in events
             if e.device_type != DeviceType.CUDA and e.name.startswith("audio_call.")}
    card = [e.time_range.start for e in events if e.device_type == DeviceType.CUDA]
    return {name: sum(1 for t in card if span.start <= t <= span.end) for name, span in spans.items()}


def phase_audio(dev):
    """audio_path: a WSJ0-2mix test-split-shaped separation evaluation (3,000
    two-speaker mixtures at 8 kHz) through SI-SDR, SDR (dense and CG), SNR,
    SI-SNR, PIT, pit_permutate and native STOI/ESTOI on the card."""
    import numpy as np
    import torch

    import metrics_tpu_torch as mtt
    import metrics_tpu_torch.functional.audio as F
    from metrics_tpu_torch.functional.audio import stoi_native

    _reset_kernel_counts()
    plan = wsj0_2mix_plan()
    batches = wsj0_2mix_batches(plan)
    metrics = _audio_metrics(mtt, dev)
    device_names = [k for k in metrics if not k.endswith("stoi")]
    stoi_names = [k for k in metrics if k.endswith("stoi")]
    events = {k: [] for k in list(metrics) + ["pit_fn", "permutate", "f64"]}
    stoi_host_s = 0.0
    perms, values = [], {k: [] for k in ("pit", "si_sdr", "sdr", "sdr_cg", "snr", "si_snr")}
    f64_err = {k: torch.zeros((), dtype=torch.float64, device=dev) for k in ("si_sdr", "sdr")}
    cg_at_dense = []
    stoi_clips = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t_all = time.perf_counter()
    data_s = 0.0

    def timed(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        events[name].append((start, end))
        return out

    for bi, index in enumerate(batches):
        t_data = time.perf_counter()
        src, shuffled = wsj0_2mix_batch(plan, index, dev)
        torch.cuda.synchronize()
        data_s += time.perf_counter() - t_data
        timed("pit", lambda: metrics["pit"].update(shuffled, src))
        best, perm = timed("pit_fn", lambda: F.permutation_invariant_training(shuffled, src, F.scale_invariant_signal_distortion_ratio))
        aligned = timed("permutate", lambda: F.pit_permutate(shuffled, perm))
        perms.append(perm)
        values["pit"].append(best)
        dense = bi % WSJ_DENSE_EVERY == 0
        for name in ("si_sdr", "sdr_cg", "snr", "si_snr") + (("sdr",) if dense else ()):
            timed(name, lambda m=metrics[name]: m.update(aligned, src))
        # per-clip values through the functions (the modules keep sums only)
        values["si_sdr"].append(F.scale_invariant_signal_distortion_ratio(aligned, src))
        values["sdr_cg"].append(F.signal_distortion_ratio(aligned, src, use_cg_iter=WSJ_CG_ITER))
        values["snr"].append(F.signal_noise_ratio(aligned, src))
        values["si_snr"].append(F.scale_invariant_signal_noise_ratio(aligned, src))
        # the same formulas in float64 on the card (the largest difference
        # kept on the card: nothing is read back in the loop)
        if dense:
            values["sdr"].append(F.signal_distortion_ratio(aligned, src))
            cg_at_dense.append(values["sdr_cg"][-1])

        def f64_check():
            a64, s64 = aligned.double(), src.double()
            f64_err["si_sdr"] = torch.maximum(f64_err["si_sdr"], (values["si_sdr"][-1].double() - F.scale_invariant_signal_distortion_ratio(a64, s64)).abs().max())
            if bi % WSJ_F64_SDR_EVERY == 0:
                f64_err["sdr"] = torch.maximum(f64_err["sdr"], (values["sdr"][-1].double() - F.signal_distortion_ratio(a64, s64)).abs().max())

        timed("f64", f64_check)
        if bi % WSJ_STOI_EVERY == 0:
            t_stoi = time.perf_counter()
            for name in stoi_names:
                timed(name, lambda m=metrics[name]: m.update(aligned, src))
            torch.cuda.synchronize()
            stoi_host_s += time.perf_counter() - t_stoi
            stoi_clips += aligned.shape[0] * aligned.shape[1]
        del src, shuffled, aligned
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_all
    peak_mem = torch.cuda.max_memory_allocated() - base_mem
    launches = _check_no_kernel_launched("audio_path")

    # PIT's permutations against the planted ones, bit for bit
    order = np.concatenate(batches)
    got_perm = torch.cat(perms).cpu().numpy()
    want_perm = np.where(plan["swapped"][order][:, None] == 1, [[1, 0]], [[0, 1]])
    if not np.array_equal(got_perm, want_perm):
        bad = int((got_perm != want_perm).any(1).sum())
        raise AssertionError(f"audio_path: PIT recovered {WSJ_MIXTURES - bad} of {WSJ_MIXTURES} planted permutations")
    per_clip = {k: torch.cat([v.reshape(-1) for v in vs]).double() for k, vs in values.items()}
    cg_at_dense = torch.cat([v.reshape(-1) for v in cg_at_dense]).double()
    f64_err = {k: float(v) for k, v in f64_err.items()}
    dense_mixtures = sum(len(index) for bi, index in enumerate(batches) if bi % WSJ_DENSE_EVERY == 0)
    for k, v in per_clip.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"audio_path: {k} has non-finite values")
    planted = float(np.mean(plan["si_sdr_db"]))

    split = {"data": data_s, "loop": loop_s, "stoi_host": stoi_host_s}
    t_checks = time.perf_counter()
    # every module's compute() against the float64 mean of the per-clip values
    computed = {k: float(m.compute()) for k, m in metrics.items()}
    mean_err = {}
    for k in ("pit", "si_sdr", "sdr", "sdr_cg", "snr", "si_snr"):
        want = float(per_clip[k].mean())
        mean_err[k] = abs(computed[k] - want) / abs(want)
        if mean_err[k] > AUDIO_MEAN_RTOL:
            raise AssertionError(f"audio_path: {k}'s compute() {computed[k]} against the clips' mean {want}")
    totals = {k: int(m.total) for k, m in metrics.items()}
    want_totals = {k: (2 * WSJ_MIXTURES if k != "pit" else WSJ_MIXTURES) for k in device_names}
    want_totals["sdr"] = 2 * dense_mixtures
    want_totals.update({k: stoi_clips for k in stoi_names})
    if totals != want_totals:
        raise AssertionError(f"audio_path: totals {totals}, not {want_totals}")
    for k in stoi_names:
        if not 0.0 < computed[k] < 1.0:
            raise AssertionError(f"audio_path: {k} {computed[k]}")

    # float64 on the card, CG against the dense solve
    for k, err in f64_err.items():
        if err > AUDIO_F64_ATOL[k]:
            raise AssertionError(f"audio_path: {k} in float32 is {err} dB from float64 (bound {AUDIO_F64_ATOL[k]})")
    cg_db = float((cg_at_dense - per_clip["sdr"]).abs().max())
    if cg_db > AUDIO_CG_DB:
        raise AssertionError(f"audio_path: CG's SDR is up to {cg_db} dB from the dense solve's (bound {AUDIO_CG_DB})")

    split["checks"] = time.perf_counter() - t_checks
    t_cpu = time.perf_counter()
    # the first WSJ_CPU_MIXTURES mixtures of the first batch (the shortest
    # clips): the card against the port on the CPU
    src, shuffled = wsj0_2mix_batch(plan, batches[0][:WSJ_CPU_MIXTURES], dev)
    card = _audio_values(src, shuffled, dev)
    t_cpu = time.perf_counter()
    cpu = _audio_values(src.cpu(), shuffled.cpu(), torch.device("cpu"))
    cpu_s = time.perf_counter() - t_cpu
    if not torch.equal(card["perm"].cpu(), cpu["perm"]):
        raise AssertionError("audio_path: PIT's permutations differ between the card and the CPU")
    cpu_err = {k: float((card[k].double().cpu() - cpu[k].double()).abs().max()) for k in AUDIO_CPU_ATOL}
    over = {k: e for k, e in cpu_err.items() if not e <= AUDIO_CPU_ATOL[k]}
    if over:
        raise AssertionError(f"audio_path: the card against the CPU {cpu_err}, over {AUDIO_CPU_ATOL}")
    vad_kept = []
    longest, _ = wsj0_2mix_batch(plan, batches[-1][:2], dev)
    for x in longest.reshape(-1, longest.shape[-1]).cpu().numpy():
        from scipy.signal import resample_poly

        x10 = resample_poly(x, 5, 4)
        kept, _ = stoi_native.remove_silent_frames(x10, x10)
        vad_kept.append(kept.size / x10.size)

    split["cpu_check"] = time.perf_counter() - t_cpu
    # blocking reads of the updates (captured: each metric replays its graph),
    # STOI's reads, and the launches a clip in a profiler window
    t_reads = time.perf_counter()
    src, shuffled = wsj0_2mix_batch(plan, batches[0], dev)
    aligned = F.pit_permutate(shuffled, F.permutation_invariant_training(shuffled, src, F.scale_invariant_signal_distortion_ratio)[1])
    reads = {k: len(blocking_reads(lambda i, m=metrics[k], a=(shuffled if k == "pit" else aligned): m.update(a, src), 3))
             for k in ("si_sdr", "snr", "si_snr", "pit", "sdr", "sdr_cg")}
    reads.update({k: len(blocking_reads(lambda i, m=metrics[k]: m.update(aligned, src), 1)) for k in stoi_names})
    if any(reads[k] for k in ("si_sdr", "snr", "pit")):
        raise AssertionError(f"audio_path: blocking reads in the SI-SDR, SNR and PIT updates: {reads}")
    clips = aligned.shape[0] * aligned.shape[1]
    split["reads"] = time.perf_counter() - t_reads
    t_profile = time.perf_counter()
    # STOI's calls (host-bound, a few hundred records a clip) on one mixture
    calls = {k: (lambda m=metrics[k], a=(shuffled if k == "pit" else aligned): m.update(a, src)) for k in device_names}
    calls.update({k: (lambda m=metrics[k]: m.update(aligned[:1], src[:1])) for k in stoi_names})
    kernels = _card_kernels(calls)
    per_clip_launches = {k: n / (2 if k in stoi_names else clips) for k, n in kernels.items()}
    split["profile"] = time.perf_counter() - t_profile
    graphs = {k: {f: getattr(m.__dict__.get("_update_graphs"), f, None) for f in ("captures", "replays", "eager_updates", "error")}
              for k, m in metrics.items()}
    for k in ("si_sdr", "snr", "si_snr", "pit", "sdr", "sdr_cg"):
        if not graphs[k]["captures"] or not graphs[k]["replays"]:
            raise AssertionError(f"audio_path: {k} did not capture its update: {graphs[k]}")
    for k in stoi_names:
        if graphs[k]["captures"] or metrics[k].jittable_update:
            raise AssertionError(f"audio_path: {k} captured its update, which reads back by design: {graphs[k]}")

    def ms(name):
        return [s.elapsed_time(e) for s, e in events[name]]

    update_ms = {k: {"p50": float(np.percentile(ms(k), 50)), "total_s": sum(ms(k)) / 1e3} for k in events}
    audio_s = float(plan["samples"].sum()) / WSJ_FS
    emit({
        "phase": "audio_path",
        "config": {"mixtures": WSJ_MIXTURES, "fs": WSJ_FS, "audio_hours": audio_s / 3600, "lengths_s": sorted(set((plan["samples"] / WSJ_FS).tolist())),
                   "mean_length_s": audio_s / WSJ_MIXTURES, "batch": WSJ_BATCH, "batches": len(batches), "cg_iter": WSJ_CG_ITER,
                   "stoi_every_batch": WSJ_STOI_EVERY, "dense_sdr_every_batch": WSJ_DENSE_EVERY, "f64_sdr_every_batch": WSJ_F64_SDR_EVERY, "dense_sdr_mixtures": dense_mixtures,
                   "cpu_mixtures": WSJ_CPU_MIXTURES, "planted_si_sdr_db_mean": planted},
        "values": computed,
        "pit_permutations_recovered": WSJ_MIXTURES,
        "clips_per_s": {k: want_totals[k] / update_ms[k]["total_s"] for k in device_names},
        "stoi_clips_per_s": {k: stoi_clips / update_ms[k]["total_s"] for k in stoi_names},
        "update_ms": update_ms,
        "cg_against_dense": {"max_abs_db": cg_db, "mean_abs_db": float((cg_at_dense - per_clip["sdr"]).abs().mean()),
                             "mean_db": float((cg_at_dense - per_clip["sdr"]).mean()),
                             "update_p50_ratio": update_ms["sdr_cg"]["p50"] / update_ms["sdr"]["p50"]},
        "against_cpu": cpu_err, "cpu_s": cpu_s,
        "float32_against_float64_db": f64_err,
        "compute_against_clip_mean_rel": mean_err,
        "launches_per_clip": per_clip_launches,
        "blocking_reads": reads,
        "graphs": graphs,
        "stoi_clips": stoi_clips, "f64_ms": sum(ms("f64")),
        "vad_kept_share": vad_kept,
        "peak_memory_bytes": peak_mem,
        "split_s": split,
        "kernel_launches": launches,
    })
    return launches


def witness_requests(seed, n, dev):
    """Ragged requests of ImageNet-sized scores (1-64 rows of 1000 classes)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = int(rng.integers(1, 65))
        p = rng.random((rows, WITNESS_CLASSES)).astype(np.float32)
        out.append((torch.from_numpy(p / p.sum(1, keepdims=True)).to(dev), torch.from_numpy(rng.integers(0, WITNESS_CLASSES, rows)).to(dev)))
    return out


def _witness_confidence(args, kwargs):
    return args[0].max(dim=-1).values


def witness_served_stream(mtt, dev, directory):
    """One host's served stream: a ServeLoop of two workers with tracing
    forced on, a drift monitor, periodic snapshots, a flight recorder and a
    FleetPublisher to an Aggregator over HTTP on 127.0.0.1. Returns the
    counts and the served updates' p50 (the serve.update spans)."""
    import numpy as np

    from metrics_tpu_torch import fleet
    from metrics_tpu_torch.obs import flightrec
    from metrics_tpu_torch.obs import trace as tr

    def proto():
        return mtt.Accuracy(num_classes=WITNESS_CLASSES, on_invalid="drop", device=dev)

    tr.reset_trace_state()
    rec = flightrec.FlightRecorder(os.path.join(directory, "flightrec"), min_interval_s=0.0)
    flightrec.install_flight_recorder(rec)
    mgr = mtt.SnapshotManager(os.path.join(directory, "snapshots"), tag="witnessed")
    monitor = mtt.DriftMonitor("top1_confidence", window=SERVE_DRIFT_WINDOW, eps=DRIFT_EPS, device=dev, extract=_witness_confidence)
    agg = fleet.Aggregator(proto(), "pod")
    server = fleet.FleetServer(agg)
    try:
        with tr.force_tracing(True):
            loop = mtt.ServeLoop(proto(), workers=2, reduce_every_s=0.05, snapshot_manager=mgr, snapshot_every_s=0.2, drift_monitors=[monitor])
            pub = fleet.FleetPublisher(loop, server.channel(), host_id="host-0", publish_every_s=0.1)
            try:
                for p, y in witness_requests(SEED + 31, WITNESS_REQUESTS, dev):
                    loop.offer(p, y)
                if not loop.drain(120):
                    raise AssertionError("lockwitness_path: the loop did not drain")
                view = loop.report(fresh=True, deadline_s=60)
                # a publish of the final view (one of the cadence's may still be in flight)
                deadline = time.monotonic() + 30
                while pub.publish_now()["default"] != "ok" and time.monotonic() < deadline:
                    time.sleep(0.05)
                loop.save_snapshot()
                rec.dump("witnessed", "the served stream's end")
            finally:
                pub.stop()
                loop.stop()
        rep = agg.report()
        durs = [r.dur_ns / 1e6 for r in tr.trace_records("serve.update")]
    finally:
        server.close()
        flightrec.install_flight_recorder(None)
    if view["updates"] != WITNESS_REQUESTS or rep["updates"] != WITNESS_REQUESTS or len(durs) != WITNESS_REQUESTS:
        raise AssertionError(f"lockwitness_path: served {view['updates']}, aggregated {rep['updates']}, {len(durs)} spans")
    return {"served_p50_ms": float(np.percentile(durs, 50)), "updates": view["updates"]}


def witness_rank(rank, world, port, results, device):
    """A rank of lockwitness_path, started with METRICS_TPU_LOCKCHECK=1: rank
    0 serves a stream before the world exists, then both ranks read an
    overlapped-sync collection (a request, the read, the fresh sync)."""
    try:
        import torch
        import torch.distributed as dist

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.analysis import lockwitness as lw
        from metrics_tpu_torch.parallel import sync

        split = {"start": time.perf_counter() - _T0}

        out = {"armed": lw.lockcheck_enabled() and type(sync.gather_sequence_lock).__name__ == "_WitnessLock"}
        if rank == 0:
            with tempfile.TemporaryDirectory() as directory:
                out["served"] = witness_served_stream(mtt, dev, directory)
        split["served"] = time.perf_counter() - _T0
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        coll = mtt.MetricCollection({
            "acc1": mtt.Accuracy(num_classes=WITNESS_CLASSES, device=dev, sync_mode="overlapped", sync_every_n=2),
            "acc5": mtt.Accuracy(num_classes=WITNESS_CLASSES, top_k=5, device=dev, sync_mode="overlapped", sync_every_n=2),
        })
        for p, y in witness_requests(SEED + 41 + rank, 8, dev):
            coll.update(p, y)
        dict(coll.items(keep_base=True, copy_state=False))["acc1"].request_sync(wait=True, deadline_s=120.0)
        read = {k: float(v) for k, v in coll.compute().items()}
        dist.barrier()
        fresh = {k: float(v) for k, v in coll.compute(fresh=True).items()}
        dist.barrier()
        split["synced"] = time.perf_counter() - _T0
        out.update(read=read, fresh=fresh, findings=lw.findings(), edges={a: sorted(b) for a, b in lw._order.items()},
                   launches=_kernel_counts(), split_s=split)
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


# the JAX package's lock hierarchy (metrics_tpu/analysis/LOCK_ORDER.md, read
# from this checkout only if it is there) by the witness's names, and the
# port's own locks (ROADMAP D64)
WITNESS_RANKS = {
    "loop.ServeLoop._replica_locks": 5, "metric._overlap_lock": 10, "aggregator._publish_lock": 20,
    "publisher._snapshot_lock": 20, "drift._check_lock": 20, "aggregator._lock": 30, "publisher._lock": 30,
    "drift._lock": 30, "async_sync._cv": 30, "async_sync._lock": 30, "loop._stats_lock": 30,
    "loop.ServeLoop._snapshot_step_lock": 35, "gather_sequence_lock": 40, "flightrec.FlightRecorder._lock": 50,
    "flightrec._sources_lock": 50, "flightrec._state_lock": 50, "runtime_metrics.RuntimeMetrics._lock": 50,
    "trace._append_lock": 50, "trace._ring_lock": 50, "health.HealthRegistry._lock": 50,
    "runtime_metrics.Counter._lock": 60, "runtime_metrics.Gauge._lock": 60, "runtime_metrics.LatencyHistogram._lock": 60,
    "_build._lock": 70, "_build._count_lock": 80, "compute._FLOAT32_LOCK": 80,
}


def witness_unarmed(rank, world, port, results, device):
    """The served stream of lockwitness_path in a process of its own that is
    not armed (started before METRICS_TPU_LOCKCHECK is set)."""
    try:
        import torch

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        import metrics_tpu_torch as mtt
        from metrics_tpu_torch.analysis import lockwitness as lw

        with tempfile.TemporaryDirectory() as directory:
            out = {"armed": lw.lockcheck_enabled(), "served": witness_served_stream(mtt, dev, directory), "launches": _kernel_counts()}
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def phase_lockwitness(dev):
    """lockwitness_path: the served stream and an overlapped sync in two ranks
    armed with METRICS_TPU_LOCKCHECK=1 (their module-level locks armed at
    import), beside the same served stream in a third process, not armed;
    the three run at once."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    unarmed = ctx.Process(target=witness_unarmed, args=(WITNESS_WORLD, WITNESS_WORLD, port, results, DIST_DEVICE))
    unarmed.start()
    os.environ["METRICS_TPU_LOCKCHECK"] = "1"  # inherited by the ranks, which import the port afresh
    try:
        procs = [ctx.Process(target=witness_rank, args=(r, WITNESS_WORLD, port, results, DIST_DEVICE)) for r in range(WITNESS_WORLD)]
        for proc in procs:
            proc.start()
    finally:
        del os.environ["METRICS_TPU_LOCKCHECK"]
    *ranks, unarmed = collect_processes(procs + [unarmed], results, "lockwitness_path")
    if unarmed["armed"]:
        raise AssertionError("lockwitness_path: the unarmed process was armed")
    launches = dict(unarmed["launches"])
    edges = sorted({(a, b) for r in ranks for a, bs in r["edges"].items() for b in bs})
    findings = [f for r in ranks for f in r["findings"]]
    if not all(r["armed"] for r in ranks):
        raise AssertionError("lockwitness_path: a rank's locks were not armed")
    if findings:
        raise AssertionError(f"lockwitness_path: the witness found {findings}")
    unranked = sorted({x for e in edges for x in e} - set(WITNESS_RANKS))
    falling = [(a, b) for a, b in edges if a in WITNESS_RANKS and b in WITNESS_RANKS and WITNESS_RANKS[a] >= WITNESS_RANKS[b]]
    if falling or unranked:
        raise AssertionError(f"lockwitness_path: edges against the lock order {falling}, locks without a rank {unranked}")
    if ranks[0]["read"] != ranks[1]["read"] or ranks[0]["read"] != ranks[0]["fresh"]:
        raise AssertionError(f"lockwitness_path: overlapped reads {[(r['read'], r['fresh']) for r in ranks]}")
    for r in ranks:
        launches = {k: v + r["launches"][k] for k, v in launches.items()}
    torch.cuda.synchronize()
    emit({
        "phase": "lockwitness_path",
        "config": {"world": WITNESS_WORLD, "requests": WITNESS_REQUESTS, "classes": WITNESS_CLASSES, "armed_by": "METRICS_TPU_LOCKCHECK=1"},
        "findings": 0,
        "order_edges": len(edges),
        "edges": [f"{a} -> {b}" for a, b in edges],
        "served_p50_ms": {"armed": ranks[0]["served"]["served_p50_ms"], "unarmed": unarmed["served"]["served_p50_ms"]},
        "overlapped_read": ranks[0]["read"],
        "kernel_launches": launches,
        "rank_split_s": [r["split_s"] for r in ranks],
    })
    return launches


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
    import metrics_tpu_torch.utilities.backend  # noqa: F401 - imported here, so the probe's thread starts at once
    probe = start_backend_probe()  # before anything here initialises CUDA

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
    with budget_time(NEW_PHASE_S, "backend_probe"):
        phase_backend_probe(probe)  # its probe ran beside the build and the parity phases
    k1_launches, cpu_bap = phase_main_path(preds, target)
    phase_windowed(preds, target)
    full_launches, full_cpu_values = phase_full_classification(preds, target, cpu_bap)
    k2_multilabel_launches = phase_multilabel(device)
    stream = make_stream(device)
    k3_launches, q_state = phase_stream(stream)
    phase_profile(preds, target)
    phase_stream_profile(stream)
    with budget_time(NEW_PHASE_S, "drift_path"):
        k3_drift_launches = phase_drift(stream)
    first_batch = stream[:STREAM_BATCH].clone()
    del stream
    k1_pure_launches, pure_values = phase_pure(device)
    phase_bootstrap(preds, target)
    ml_world_values = phase_regression(device)
    phase_pairwise(device)
    # the kernels' times, before any path spawns its ranks
    kernels = [
        k1_times(preds, target, k1_launches, k1_err),
        k2_times(device, k2_err),
        k3_times(device, k3_launches, k3_err, k3_fold_err, q_state, first_batch),
    ]
    kernels[1]["confmat_shape"] = k2_confmat_times(preds, target, full_launches["histogram"])
    # the compiled update and serving, after the kernels line's profiler windows
    k1_compiled_launches, capture_checks = phase_compiled(preds, target)
    k1_serving_launches = phase_with_ladder(SERVE_LADDER, phase_serving, preds, target)
    phase_with_ladder(SERVE_LADDER, phase_coldstart, preds, target)
    with budget_time(NEW_PHASE_S, "serving_obs_path"):
        k1_serving_obs_launches, k3_serving_obs_launches = phase_with_ladder(
            SERVE_LADDER, phase_serving_obs, preds, target, dict(_SERVING_LATENCY))
    with budget_time(SLICE_PHASE_S, "fleet_path"):
        k1_fleet_launches, k3_fleet_launches = phase_with_ladder(SERVE_LADDER, phase_fleet, preds, target)
    del preds, target, q_state, first_batch
    torch.cuda.empty_cache()
    phase_retrieval(device)
    k1_sliced_launches = phase_sliced(device)
    k2_launches = phase_dist(device)
    k2_path_launches(kernels[1], k2_launches)
    k1_fused_launches, fused_values = phase_fused_eval(device, pure_values, ml_world_values)
    k3_fused_launches, k3_restore_launches = phase_fused_sketch(device)
    k1_overlapped_launches, k3_quantized_launches = phase_sync_layer(device, fused_values)
    k1_full_dist_launches, k2_full_dist_launches = phase_full_classification_dist(full_cpu_values)
    # the image slice: no kernel of K1-K3 on its path
    torch.cuda.empty_cache()
    phase_image_functional(device)
    phase_fid50k(device)
    phase_lpips_ssim(device)
    # the text slice: no kernel of K1-K3 on its path either
    torch.cuda.empty_cache()
    phase_text_summarization(device)
    phase_text_metrics(device)
    # the detection slice: no kernel of K1-K3 on its path either
    torch.cuda.empty_cache()
    with budget_time(SLICE_PHASE_S, "detection_path"):
        phase_detection(device)
    # the audio slice: no kernel of K1-K3 on its path either
    torch.cuda.empty_cache()
    with budget_time(AUDIO_PHASE_S, "audio_path"):
        audio_launches = phase_audio(device)
    with budget_time(AUDIO_PHASE_S, "lockwitness_path"):
        witness_launches = phase_lockwitness(device)
    # each kernel's launches on every path that runs it, each path counted
    # from zero just before it
    kernels[0]["launches_by_path"] = {
        "main_path": k1_launches, "fused_dist_path": k1_fused_launches, "overlapped_path": k1_overlapped_launches,
        "full_classification_path": full_launches["binned_counters"], "full_classification_dist": k1_full_dist_launches,
        "pure_path": k1_pure_launches, "sliced_path": k1_sliced_launches,
        "compiled_path": k1_compiled_launches, "serving_path": k1_serving_launches,
        "serving_obs_path": k1_serving_obs_launches, "fleet_path": k1_fleet_launches,
    }
    kernels[1]["launches_by_path"] = {
        "dist_path": k2_launches, "full_classification_path": full_launches["histogram"],
        "multilabel_path": k2_multilabel_launches, "full_classification_dist": k2_full_dist_launches,
        "compiled_path_capture_check": capture_checks["histogram"]["launches"]["captured"],
    }
    kernels[2]["launches_by_path"] = {"stream_path": k3_launches, "fused_sketch_path": k3_fused_launches, "quantized_sketch_path": k3_quantized_launches,
                                      "compiled_path_capture_check": capture_checks["compactor_fold"]["launches"]["captured"],
                                      "drift_path": k3_drift_launches, "serving_obs_path": k3_serving_obs_launches,
                                      "fleet_path": k3_fleet_launches,
                                      "snapshot_path_sketch_restore": k3_restore_launches}
    for kernel, name in zip(kernels, ("binned_counters", "histogram", "compactor_fold")):
        kernel["launches_by_path"]["audio_path"] = audio_launches[name]
        kernel["launches_by_path"]["lockwitness_path"] = witness_launches[name]
    emit({"phase": "budget", "new_phases_s": NEW_PHASE_S, "new_phases_total_s": sum(NEW_PHASE_S.values()),
          "new_phases_limit_s": NEW_PHASES_LIMIT_S, "slice_phases_s": SLICE_PHASE_S,
          "slice_phases_total_s": sum(SLICE_PHASE_S.values()), "slice_phases_limit_s": SLICE_PHASES_LIMIT_S,
          "audio_phases_s": AUDIO_PHASE_S, "audio_phases_total_s": sum(AUDIO_PHASE_S.values()),
          "audio_phases_limit_s": AUDIO_PHASES_LIMIT_S,
          "script_s": time.perf_counter() - _T0})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})


if __name__ == "__main__":
    main()
