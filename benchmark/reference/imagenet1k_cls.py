"""Plain reference of the ``imagenet1k_cls`` configuration: multi-class
scores ``(N, C)`` and class ids ``(N,)``, optionally split into cohorts.

It works out again, from the inputs that the program was handed, every value
that the collection's ``compute()`` returns: top-k accuracy, binned average
precision per class, macro or micro precision, recall and F1, each per cohort
and over all rows where the traffic wraps the members in ``SlicedMetric``
over the rows' ``slice_ids`` (the program's ``SlicedValue``: ``per_slice``,
``global_value``, ``quarantined_rows``). Counts are exact int64 sums taken in row chunks on the
inputs' device; values are float64. Groups: ``acc`` (accuracies, and each
sliced member's quarantined rows), ``ap``, ``prf``.

``expected(..., control=True)`` is the control: the same reference on the
scores rounded to bfloat16, the precision below the configuration's float32.
"""
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.reference.common import ap_from_hist, bins, flat, lowered, row_chunks, stat_score, thresholds

BINNED = ("BinnedAveragePrecision",)
STAT = {"Precision": "precision", "Recall": "recall", "F1Score": "f1"}


def _top_k(spec: Dict[str, Any]) -> int:
    args = spec["args"]
    if args.get("average", "micro") != "micro" or args.get("multiclass") is not None:
        raise NotImplementedError(f"Accuracy with {args}")
    return int(args.get("top_k") or 1)


def _slices(members: Dict[str, Dict[str, Any]]) -> int:
    """The cohorts the members are split into (0: not split)."""
    wraps = [s["wrap"] for s in members.values() if s.get("wrap")]
    if any(w["metric"] != "SlicedMetric" for w in wraps):
        raise NotImplementedError(f"no reference for the wrapper in {wraps}")
    if wraps and len(wraps) < len(members):
        raise NotImplementedError("every member sliced, or none")
    return int(wraps[0]["args"]["num_slices"]) if wraps else 0


def _counts(inputs: Any, members: Dict[str, Dict[str, Any]], control: bool) -> Dict[str, Any]:
    """Exact counts per cohort (one cohort where the rows are not split):
    rows, correct rows at each top-k, per-class tp/fp/fn of the argmax, and
    per (class, bin, label) histograms at each threshold count."""
    preds, target = inputs.args
    n, c = preds.shape
    dev = preds.device
    k_slices = max(1, _slices(members))
    ids = inputs.kwargs["slice_ids"] if _slices(members) else torch.zeros((n,), dtype=torch.int64, device=dev)
    tops = sorted({_top_k(s) for s in members.values() if s["metric"] == "Accuracy"})
    t_counts = sorted({int(s["args"].get("thresholds", 100)) for s in members.values() if s["metric"] in BINNED})
    thr = {t: thresholds(t, dev) for t in t_counts}
    rows = torch.zeros((k_slices,), dtype=torch.int64, device=dev)
    correct = {k: torch.zeros((k_slices,), dtype=torch.int64, device=dev) for k in tops}
    stat = torch.zeros((3, k_slices * c), dtype=torch.int64, device=dev)  # tp, fp, fn per (cohort, class)
    hist = {t: torch.zeros((k_slices * c * (t + 1) * 2,), dtype=torch.int64, device=dev) for t in t_counts}
    classes = torch.arange(c, device=dev)
    for lo, hi in row_chunks(n, c):
        p = lowered(preds[lo:hi], control)
        y = target[lo:hi].to(torch.int64)
        s = ids[lo:hi].to(torch.int64)
        rows += torch.bincount(s, minlength=k_slices)
        for k in tops:
            hit = (torch.topk(p, k, dim=1).indices == y[:, None]).any(dim=1)
            correct[k] += torch.bincount(s[hit], minlength=k_slices)
        top1 = torch.argmax(p, dim=1)
        right = top1 == y
        stat[0] += torch.bincount(s[right] * c + y[right], minlength=k_slices * c)
        stat[1] += torch.bincount(s[~right] * c + top1[~right], minlength=k_slices * c)
        stat[2] += torch.bincount(s[~right] * c + y[~right], minlength=k_slices * c)
        label = (y[:, None] == classes[None, :]).to(torch.int64)
        for t in t_counts:
            key = ((s[:, None] * c + classes[None, :]) * (t + 1) + bins(p, thr[t])) * 2 + label
            hist[t] += torch.bincount(key.reshape(-1), minlength=hist[t].numel())
    return {
        "rows": rows.cpu().numpy(), "correct": {k: v.cpu().numpy() for k, v in correct.items()},
        "stat": stat.reshape(3, k_slices, c).cpu().numpy(),
        "hist": {t: h.reshape(k_slices, c, t + 1, 2).cpu().numpy() for t, h in hist.items()},
    }


def expected(inputs: Any, members: Dict[str, Dict[str, Any]], control: bool = False) -> Dict[str, np.ndarray]:
    """``{group: values}`` in the order of :func:`observed`."""
    counts = _counts(inputs, members, control)
    sliced = _slices(members) > 0
    groups: Dict[str, List[np.ndarray]] = {"acc": [], "ap": [], "prf": []}
    for name in sorted(members):
        spec = members[name]
        kind = spec["metric"]
        if kind == "Accuracy":
            right, rows = counts["correct"][_top_k(spec)], counts["rows"]
            per, whole = right / rows, right.sum() / rows.sum()
            groups["acc"] += [per, [whole]] if sliced else [[whole]]
        elif kind in BINNED:
            h = counts["hist"][int(spec["args"].get("thresholds", 100))]
            per, whole = ap_from_hist(h), ap_from_hist(h.sum(axis=0))  # (K, C), (C,)
            groups["ap"] += [per.T, whole] if sliced else [whole]
        elif kind in STAT:
            tp, fp, fn = counts["stat"]
            average = spec["args"].get("average", "micro")
            per = stat_score(STAT[kind], average, tp, fp, fn)
            whole = stat_score(STAT[kind], average, tp.sum(0), fp.sum(0), fn.sum(0))
            groups["prf"] += [per, [whole]] if sliced else [[whole]]
        else:
            raise NotImplementedError(f"no reference for {kind}")
        if sliced:
            groups["acc"].append([0.0])  # every cohort id lies in range: no row quarantined
    return flat(groups)


def observed(values: Dict[str, Any], members: Dict[str, Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """The program's ``compute()`` values (on the host) in the layout of
    :func:`expected`."""
    groups: Dict[str, List[np.ndarray]] = {"acc": [], "ap": [], "prf": []}
    for name in sorted(members):
        kind, value = members[name]["metric"], values[name]
        group = "acc" if kind == "Accuracy" else "ap" if kind in BINNED else "prf" if kind in STAT else None
        if group is None:
            raise NotImplementedError(f"no reference for {kind}")
        if _slices(members):
            groups[group] += [np.asarray(value.per_slice, dtype=np.float64), np.asarray(value.global_value, dtype=np.float64)]
            groups["acc"].append(np.asarray(value.quarantined_rows, dtype=np.float64))
        else:
            groups[group].append(np.asarray(value, dtype=np.float64))
    return flat(groups)

