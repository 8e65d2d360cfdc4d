"""Plain reference of the ``deepglobe_road`` configuration: a binary task,
one score and one 0/1 mask value per pixel, flattened to ``(N,)``.

It works out again, from the inputs that the program was handed, the binned
average precision of the road class (the PR curve's area) and the Jaccard
index (IoU) of the thresholded scores against the masks as
``JaccardIndex(num_classes=2)`` gives it: per class with ``average="none"``
(the road class's IoU being the challenge's score), or their mean. Counts are exact
int64 sums taken in chunks of pixels on the inputs' device; values are
float64.

``expected(..., control=True)`` is the control: the same reference on the
scores rounded to bfloat16, the precision below the configuration's float32.
"""
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.reference.common import ap_from_hist, bins, flat, iou, lowered, row_chunks, thresholds

BINNED = ("BinnedAveragePrecision",)
IOU = ("JaccardIndex",)


def _check(spec: Dict[str, Any]) -> None:
    args = spec["args"]
    if spec["metric"] in BINNED and int(args.get("num_classes", 1)) != 1:
        raise NotImplementedError("deepglobe_road: the binned curve of one class")
    if spec["metric"] in IOU and (int(args["num_classes"]) != 2 or args.get("ignore_index") is not None or args.get("multilabel")):
        raise NotImplementedError(f"deepglobe_road: JaccardIndex with {args}")


def expected(inputs: Any, members: Dict[str, Dict[str, Any]], control: bool = False) -> Dict[str, np.ndarray]:
    """``{group: values}`` in the order of :func:`observed`."""
    for spec in members.values():
        _check(spec)
        if spec.get("wrap"):
            raise NotImplementedError(f"deepglobe_road: no reference for the wrapper {spec['wrap']}")
    scores, masks = inputs.args
    dev = scores.device
    t_counts = sorted({int(s["args"].get("thresholds", 100)) for s in members.values() if s["metric"] in BINNED})
    cuts = sorted({float(s["args"].get("threshold", 0.5)) for s in members.values() if s["metric"] in IOU})
    thr = {t: thresholds(t, dev) for t in t_counts}
    hist = {t: torch.zeros((2 * (t + 1),), dtype=torch.int64, device=dev) for t in t_counts}
    confmat = {cut: torch.zeros((4,), dtype=torch.int64, device=dev) for cut in cuts}
    for lo, hi in row_chunks(scores.shape[0], 1, budget=1 << 26):
        s = lowered(scores[lo:hi], control)
        y = (masks[lo:hi] == 1).to(torch.int64)
        for t in t_counts:
            hist[t] += torch.bincount(bins(s, thr[t]) * 2 + y, minlength=hist[t].numel())
        for cut in cuts:
            confmat[cut] += torch.bincount(y * 2 + (s >= cut).to(torch.int64), minlength=4)
    groups: Dict[str, List[np.ndarray]] = {"ap": [], "iou": []}
    for name in sorted(members):
        spec = members[name]
        if spec["metric"] in BINNED:
            t = int(spec["args"].get("thresholds", 100))
            groups["ap"].append([ap_from_hist(hist[t].reshape(t + 1, 2).cpu().numpy())])
        else:
            cm = confmat[float(spec["args"].get("threshold", 0.5))].reshape(2, 2).cpu().numpy()
            groups["iou"].append([iou(cm, spec["args"].get("average", "macro"), float(spec["args"].get("absent_score", 0.0)))])
    return flat(groups)


def observed(values: Dict[str, Any], members: Dict[str, Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """The program's ``compute()`` values (on the host) in the layout of
    :func:`expected`."""
    groups: Dict[str, List[np.ndarray]] = {"ap": [], "iou": []}
    for name in sorted(members):
        kind = members[name]["metric"]
        if kind not in BINNED + IOU:
            raise NotImplementedError(f"no reference for {kind}")
        groups["ap" if kind in BINNED else "iou"].append(np.asarray(values[name], dtype=np.float64))
    return flat(groups)
