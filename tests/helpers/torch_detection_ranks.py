"""Seeded COCO-shaped detection data and the ranks of the two-process
``MeanAveragePrecision`` check in ``tests/test_torch_detection.py``
(ROADMAP F12, D60): one Gloo process each, importing torch, numpy and the
port only (neither JAX nor ``metrics_tpu``).

``coco_like`` draws images whose ground-truth boxes follow COCO's shares of
small, medium and large objects (about 41/34/24 %), and detections that are
jittered copies of them, exact duplicates (equal IoUs and scores), label
swaps and false positives, with seeded scores.
"""
import sys
import traceback
import warnings

import numpy as np

from tests.helpers.torch_fused_sync_ranks import Recorder, _numpy

# each rank's share of the two-process check: image ranges of one seeded set
RANK_IMAGES = [(0, 5), (5, 12)]
WORLD_SET = {"n": 12, "seed": 7, "classes": 5}
# the mask resolutions of the segm run, alternating by image
SEGM_SHAPES = ((48, 64), (64, 48))


def coco_like(n, seed, classes=8, segm=False, shapes=((480, 640), (640, 480)), max_gt=9, fp=3):
    """``n`` images of ``(preds, targets)`` dicts of numpy arrays: boxes in
    xyxy (``masks`` filled inside the boxes with ``segm=True``)."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        ng = int(rng.integers(0, max_gt + 1))
        # sides log-uniform over [2, min(h, w)]: small / medium / large objects
        side = np.exp(rng.uniform(np.log(2.0), np.log(min(h, w)), (ng, 2)))
        x1 = rng.uniform(0, w - side[:, 0])
        y1 = rng.uniform(0, h - side[:, 1])
        gt = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], axis=1).astype(np.float32)
        gt_labels = rng.integers(0, classes, ng)
        keep = rng.random(ng) < 0.8
        jitter = rng.normal(0.0, 0.08, (ng, 4)) * np.repeat(side, 2, axis=1)
        det = np.clip(gt + jitter.astype(np.float32), 0, [w, h, w, h]).astype(np.float32)[keep]
        det_labels = gt_labels[keep].copy()
        swap = rng.random(det_labels.size) < 0.1
        det_labels[swap] = rng.integers(0, classes, int(swap.sum()))
        scores = rng.random(det.shape[0]).astype(np.float32)
        if det.shape[0]:
            # an exact duplicate of the first detection: equal IoUs and scores
            det = np.concatenate([det, det[:1]])
            det_labels = np.concatenate([det_labels, det_labels[:1]])
            scores = np.concatenate([scores, scores[:1]])
        nf = int(rng.integers(0, fp + 1))
        fs = np.exp(rng.uniform(np.log(2.0), np.log(min(h, w)), (nf, 2)))
        fx, fy = rng.uniform(0, w - fs[:, 0]), rng.uniform(0, h - fs[:, 1])
        det = np.concatenate([det, np.stack([fx, fy, fx + fs[:, 0], fy + fs[:, 1]], axis=1).astype(np.float32)])
        det_labels = np.concatenate([det_labels, rng.integers(0, classes, nf)])
        scores = np.concatenate([scores, rng.random(nf).astype(np.float32)])
        if segm:
            preds.append(dict(masks=_fill(det, h, w), scores=scores, labels=det_labels))
            targets.append(dict(masks=_fill(gt, h, w), labels=gt_labels))
        else:
            preds.append(dict(boxes=det.reshape(-1, 4), scores=scores, labels=det_labels))
            targets.append(dict(boxes=gt.reshape(-1, 4), labels=gt_labels))
    return preds, targets


def _fill(boxes, h, w):
    """Masks ``(n, h, w)`` filled inside each box (at least one pixel)."""
    masks = np.zeros((boxes.shape[0], h, w), bool)
    for k, (x1, y1, x2, y2) in enumerate(boxes):
        c1, r1 = min(int(x1), w - 1), min(int(y1), h - 1)
        masks[k, r1:max(int(np.ceil(y2)), r1 + 1), c1:max(int(np.ceil(x2)), c1 + 1)] = True
    return masks


def world_data(segm):
    shapes = SEGM_SHAPES if segm else ((480, 640), (640, 480))
    return coco_like(WORLD_SET["n"], WORLD_SET["seed"], WORLD_SET["classes"], segm=segm, shapes=shapes)


def rank_main(rank, world, store, queue, segm=False):
    try:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
        warnings.simplefilter("ignore")
        import metrics_tpu_torch as mtt

        preds, targets = world_data(segm)
        lo, hi = RANK_IMAGES[rank]
        metric = mtt.detection.MeanAveragePrecision(iou_type="segm" if segm else "bbox", class_metrics=True, device="cpu")
        for start in range(lo, hi, 3):  # a few updates per rank
            metric.update(preds[start:min(start + 3, hi)], targets[start:min(start + 3, hi)])
        with Recorder(dist) as rec:
            value = metric.compute()
        out = {"value": _numpy(value), "calls": rec.calls, "local_images": len(metric.image_sizes)}
        out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "metrics_tpu"))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
