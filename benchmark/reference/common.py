"""Plain PyTorch and NumPy pieces that the configurations' references share.

The definitions are TorchMetrics' (0.x), which ``metrics_tpu_torch``
ports: binned curves compare ``score >= threshold`` against ``T`` evenly
spaced thresholds on ``[0, 1]``; ``METRIC_EPS = 1e-6`` guards the binned
precision and recall; a macro average leaves out the classes that no row
predicts or holds. Counts are exact (int64) and values float64. Nothing
here imports the program.
"""
from typing import Dict, List, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

METRIC_EPS = 1e-6


def thresholds(count: int, device: torch.device) -> Tensor:
    """``count`` thresholds evenly spaced on ``[0, 1]`` as float32:
    ``float32(i / (count - 1))``."""
    if count == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    return (torch.arange(count, dtype=torch.float64, device=device) / (count - 1)).to(torch.float32)


def bins(scores: Tensor, thr: Tensor) -> Tensor:
    """For each score, how many of the ascending thresholds ``thr`` it
    reaches (``score >= t``): 0 to ``T``. A score clears threshold ``j``
    exactly when its bin is above ``j``."""
    return torch.searchsorted(thr, scores.to(torch.float32).contiguous(), right=True)


def ap_from_hist(hist: np.ndarray) -> np.ndarray:
    """Binned average precision from ``hist[..., b, label]`` (rows of each bin
    ``b`` of :func:`bins`, negatives at label 0 and positives at 1): the
    step integral ``-sum(diff(recall) * precision[:-1])`` over the curve
    with the point (recall 0, precision 1) appended."""
    hist = hist.astype(np.int64)
    at_or_above = np.flip(np.cumsum(np.flip(hist, axis=-2), axis=-2), axis=-2)  # rows in bins >= b
    cleared = at_or_above[..., 1:, :].astype(np.float64)  # rows whose score reaches threshold j
    tp, fp = cleared[..., 1], cleared[..., 0]
    positives = hist[..., 1].sum(axis=-1, keepdims=True).astype(np.float64)
    fn = positives - tp
    precision = (tp + METRIC_EPS) / (tp + fp + METRIC_EPS)
    recall = tp / (tp + fn + METRIC_EPS)
    ones = np.ones(precision.shape[:-1] + (1,))
    precision = np.concatenate([precision, ones], axis=-1)
    recall = np.concatenate([recall, np.zeros_like(ones)], axis=-1)
    return -np.sum((recall[..., 1:] - recall[..., :-1]) * precision[..., :-1], axis=-1)


def _safe(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def stat_score(kind: str, average: str, tp: np.ndarray, fp: np.ndarray, fn: np.ndarray) -> np.ndarray:
    """Precision, recall or F1 over the last (class) axis of the counts.
    ``macro``: the mean over the classes that some row predicts or holds
    (0 where there is none), each class's score 0 where it divides by 0;
    ``micro``: the score of the summed counts."""
    tp, fp, fn = (np.asarray(x, dtype=np.float64) for x in (tp, fp, fn))
    if average == "micro":
        tp, fp, fn = tp.sum(-1), fp.sum(-1), fn.sum(-1)
    p, r = _safe(tp, tp + fp), _safe(tp, tp + fn)
    score = {"precision": p, "recall": r, "f1": _safe(2 * p * r, p + r)}[kind]
    if average == "micro":
        return score
    if average != "macro":
        raise NotImplementedError(f"average={average!r}")
    present = (tp + fp + fn) > 0
    n = present.sum(-1)
    return np.where(n == 0, 0.0, np.where(present, score, 0.0).sum(-1) / np.maximum(n, 1))


def iou(confmat: np.ndarray, average: str = "macro", absent_score: float = 0.0) -> np.ndarray:
    """Intersection over union per class of ``confmat[target, pred]``,
    ``absent_score`` where a class is in no row's target or prediction."""
    cm = np.asarray(confmat, dtype=np.float64)
    inter = np.diagonal(cm, axis1=-2, axis2=-1)
    union = cm.sum(-2) + cm.sum(-1) - inter
    scores = np.where(union == 0, absent_score, inter / np.where(union == 0, 1.0, union))
    if average == "macro":
        return scores.mean(-1)
    if average in ("none", None):
        return scores
    raise NotImplementedError(f"average={average!r}")


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest absolute difference; infinite where the shapes differ or
    one side holds NaN where the other does not."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    nan_got, nan_want = np.isnan(got), np.isnan(want)
    if (nan_got != nan_want).any():
        return float("inf")
    diff = np.abs(np.where(nan_got, 0.0, got) - np.where(nan_want, 0.0, want))
    return float(diff.max())


def flat(groups: Dict[str, List[np.ndarray]]) -> Dict[str, np.ndarray]:
    """``{group: one float64 vector}`` from lists of arrays."""
    return {g: np.concatenate([np.asarray(a, dtype=np.float64).reshape(-1) for a in parts]) for g, parts in groups.items() if parts}


def lowered(scores: Tensor, control: bool) -> Tensor:
    """The scores as the reference reads them: float32, or rounded to
    bfloat16 first for the lower-precision control."""
    return scores.to(torch.bfloat16).to(torch.float32) if control else scores.to(torch.float32)


def row_chunks(rows: int, per_row: int, budget: int = 1 << 23) -> List[Tuple[int, int]]:
    """``[lo, hi)`` row ranges of at most ``budget`` elements of width ``per_row``."""
    step = max(1, budget // max(1, per_row))
    return [(lo, min(rows, lo + step)) for lo in range(0, rows, step)]
