"""The plain references at tiny sizes on the CPU, against values worked out
by hand."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.reference import common, deepglobe_road, imagenet1k_cls

EPS = common.METRIC_EPS


def inputs(preds, target, ids=None):
    return SimpleNamespace(args=(torch.tensor(preds, dtype=torch.float32), torch.tensor(target)),
                           kwargs={} if ids is None else {"slice_ids": torch.tensor(ids)})


def sliced(members, k):
    """``members`` each wrapped in ``SlicedMetric(num_slices=k)``."""
    return {name: {**spec, "wrap": {"metric": "SlicedMetric", "args": {"num_slices": k}}} for name, spec in members.items()}


def test_thresholds_are_float32_of_i_over_t_minus_1_and_the_ports():
    from metrics_tpu_torch.utilities.data import jax_linspace

    thr = common.thresholds(100, torch.device("cpu"))
    assert thr.dtype == torch.float32 and float(thr[0]) == 0.0 and float(thr[-1]) == 1.0
    assert float(thr[1]) == float(np.float32(1 / 99))
    # the port's thresholds (JAX's float32 linspace) are the same bits at 100
    assert torch.equal(thr, jax_linspace(0, 1.0, 100, device="cpu"))


def test_bins_count_the_thresholds_a_score_reaches():
    thr = torch.tensor([0.0, 0.5, 1.0])
    assert common.bins(torch.tensor([0.0, 0.49, 0.5, 0.99, 1.0]), thr).tolist() == [1, 1, 2, 2, 3]


def test_binned_ap_by_hand():
    # scores 0.1, 0.4 (negatives), 0.35, 0.8 (positives); thresholds 0, 0.5, 1:
    # tp (2, 1, 0), fp (2, 0, 0), fn (0, 1, 2)
    # AP = -[(r1 - r0) p0 + (r2 - r1) p1 + (0 - r2) p2] = 1/(4+e) + 1/(2+e)
    hist = np.zeros((4, 2), dtype=np.int64)
    thr = torch.tensor([0.0, 0.5, 1.0])
    for s, y in ((0.1, 0), (0.4, 0), (0.35, 1), (0.8, 1)):
        hist[int(common.bins(torch.tensor([s]), thr)[0]), y] += 1
    assert common.ap_from_hist(hist) == pytest.approx(1 / (4 + EPS) + 1 / (2 + EPS), abs=1e-15)


def test_macro_scores_leave_out_absent_classes():
    # class 0: tp 2 fp 1 fn 0; class 1: tp 0 fp 0 fn 1; class 2: nothing (left out)
    tp, fp, fn = np.array([2, 0, 0]), np.array([1, 0, 0]), np.array([0, 1, 0])
    assert common.stat_score("precision", "macro", tp, fp, fn) == pytest.approx((2 / 3 + 0) / 2)
    assert common.stat_score("recall", "macro", tp, fp, fn) == pytest.approx((1 + 0) / 2)
    f1_0 = 2 * (2 / 3) * 1 / (2 / 3 + 1)
    assert common.stat_score("f1", "macro", tp, fp, fn) == pytest.approx(f1_0 / 2)
    assert common.stat_score("precision", "micro", tp, fp, fn) == pytest.approx(2 / 3)
    assert common.stat_score("recall", "macro", np.zeros(3), np.zeros(3), np.zeros(3)) == 0.0


def test_iou_by_hand():
    assert common.iou(np.array([[3, 1], [2, 4]])) == pytest.approx((3 / 6 + 4 / 7) / 2)
    assert common.iou(np.array([[5, 0], [0, 0]]), absent_score=0.0) == pytest.approx(0.5)


def test_gap_marks_shape_and_nan_mismatches():
    assert common.gap(np.array([1.0, 2.0]), np.array([1.0, 2.5])) == 0.5
    assert common.gap(np.array([1.0]), np.array([1.0, 2.0])) == math.inf
    assert common.gap(np.array([np.nan]), np.array([1.0])) == math.inf
    assert common.gap(np.array([np.nan]), np.array([np.nan])) == 0.0


MEMBERS = {
    "acc1": {"metric": "Accuracy", "args": {"num_classes": 3}},
    "acc2": {"metric": "Accuracy", "args": {"num_classes": 3, "top_k": 2}},
    "prec": {"metric": "Precision", "args": {"num_classes": 3, "average": "macro"}},
}
# four rows over three classes: argmax 0, 1, 1, 2; second best 1, 2, 0, 0
PREDS = [[0.6, 0.3, 0.1], [0.1, 0.5, 0.4], [0.3, 0.6, 0.1], [0.3, 0.1, 0.6]]
TARGET = [0, 2, 1, 1]


def test_imagenet_reference_by_hand():
    got = imagenet1k_cls.expected(inputs(PREDS, TARGET), MEMBERS)
    # top-1 right on rows 0 and 2; top-2 also on row 1 (2 is second); row 3 (1) is third
    assert got["acc"].tolist() == pytest.approx([2 / 4, 3 / 4])
    # precision: class 0 1/1, class 1 1/2, class 2 0/1 -> macro over the three present classes
    assert got["prf"].tolist() == pytest.approx([(1 + 0.5 + 0) / 3])


def test_imagenet_reference_per_cohort_by_hand():
    got = imagenet1k_cls.expected(inputs(PREDS, TARGET, ids=[0, 0, 1, 1]), sliced(MEMBERS, 2))
    # acc1 per cohort (1/2, 1/2) and over all; acc2 (1, 1/2) and over all
    # each sliced member's quarantined rows (none) follow its values in the acc group, prec's too
    assert got["acc"].tolist() == pytest.approx([0.5, 0.5, 0.5, 0.0, 1.0, 0.5, 0.75, 0.0, 0.0])
    # cohort 0: class 0 tp1; class 1 fp1; class 2 fn1 -> (1 + 0 + 0) / 3
    # cohort 1: class 1 tp1 fn1; class 2 fp1 -> (1 + 0) / 2; over all 1/2
    assert got["prf"].tolist() == pytest.approx([1 / 3, 1 / 2, 1 / 2])


def test_binned_ap_per_class_and_cohort_match_the_binary_formula():
    members = {"bap": {"metric": "BinnedAveragePrecision", "args": {"num_classes": 3, "thresholds": 3}}}
    got = imagenet1k_cls.expected(inputs(PREDS, TARGET, ids=[0, 0, 1, 1]), sliced(members, 2))["ap"].reshape(-1)
    # class 1 over all rows: scores 0.3, 0.5, 0.6, 0.1, positives rows 2 and 3 (0.6, 0.1)
    # thresholds 0, 0.5, 1: tp (2, 1, 0), fp (2, 1, 0), fn (0, 1, 2)
    p = [(2 + EPS) / (4 + EPS), (1 + EPS) / (2 + EPS), 1.0, 1.0]
    r = [2 / (2 + EPS), 1 / (2 + EPS), 0.0, 0.0]
    want = -sum((r[i + 1] - r[i]) * p[i] for i in range(3))
    # layout: per cohort (class-major, 3 x 2), then over all (3)
    assert got[6 + 1] == pytest.approx(want, abs=1e-15)


@pytest.mark.parametrize("average", ["macro", "none"])
def test_deepglobe_reference_by_hand(average):
    members = {"iou": {"metric": "JaccardIndex", "args": {"num_classes": 2, "average": average}},
               "pr_ap": {"metric": "BinnedAveragePrecision", "args": {"num_classes": 1, "thresholds": 3}}}
    got = deepglobe_road.expected(inputs([0.1, 0.4, 0.35, 0.8, 0.5], [0, 0, 1, 1, 0]), members)
    # at 0.5: target 0 -> preds 0, 0, 1; target 1 -> 0, 1: confmat [[2, 1], [1, 1]];
    # background IoU 2 / 4, road IoU 1 / 3 (the challenge's score)
    per_class = [2 / 4, 1 / 3]
    assert got["iou"].tolist() == pytest.approx([sum(per_class) / 2] if average == "macro" else per_class)
    # with the negative at 0.5: tp (2, 1, 0), fp (3, 1, 0), fn (0, 1, 2)
    p = [(2 + EPS) / (5 + EPS), (1 + EPS) / (2 + EPS), 1.0, 1.0]
    r = [2 / (2 + EPS), 1 / (2 + EPS), 0.0, 0.0]
    assert got["ap"].tolist() == pytest.approx([-sum((r[i + 1] - r[i]) * p[i] for i in range(3))], abs=1e-15)


def test_control_rounds_scores_to_bfloat16():
    s = torch.tensor([0.1234567], dtype=torch.float32)
    assert float(common.lowered(s, True)) == float(s.to(torch.bfloat16).float()) != float(s)
