"""The port's detection metrics (``metrics_tpu_torch/detection/``) against the
JAX package's on the CPU: the box helpers, the batched IoUs and the greedy
matcher bit-equal on seeded inputs, ``MeanAveragePrecision`` equal to JAX's
on every case of ``tests/detection/test_map.py`` and on a seeded 64-image
COCO-shaped set in ``bbox`` and ``segm`` (mixed resolutions), and F12 with
its repair D60: image boundaries survive a sync (a fake two-rank world and
a two-process Gloo world), where the JAX package's synced value is wrong.

Tolerance: none. The matches are exact booleans and the accumulation is the
same float64 numpy, so every output is compared bit for bit.
"""
import multiprocessing as mp
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu_torch as mtt  # noqa: E402
import tests.helpers.torch_detection_ranks as R  # noqa: E402
from metrics_tpu.detection import MeanAveragePrecision as JMAP  # noqa: E402
from metrics_tpu.detection import helpers as jhelpers  # noqa: E402
from metrics_tpu.detection import matcher as jmatcher  # noqa: E402
from metrics_tpu_torch.detection import helpers as thelpers  # noqa: E402
from metrics_tpu_torch.detection import matcher as tmatcher  # noqa: E402
from tests.detection.test_map import _PREDS, _TARGET  # noqa: E402
from tests.detection.test_matcher import _oracle  # noqa: E402
from tests.helpers.torch_twin_world import TwinWorld  # noqa: E402

TMAP = mtt.detection.MeanAveragePrecision
FORMATS = ("xyxy", "xywh", "cxcywh")


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _seeded_boxes(rng, n, scale=100.0):
    """xyxy float32 boxes with degenerate rows: zero width, zero height, a
    point, and a row repeated."""
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(0, scale / 2, (n, 2))
    wh[: n // 6, 0] = 0.0
    wh[n // 6 : n // 3, 1] = 0.0
    wh[n // 3 : n // 3 + 1] = 0.0
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[-1] = boxes[0]
    return boxes


def _assert_bits(port, ref, what):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (what, port.shape, ref.shape, port.dtype, ref.dtype)
    np.testing.assert_array_equal(port.reshape(-1).view(np.uint8), ref.reshape(-1).view(np.uint8), err_msg=what)


# ----------------------------------------------------------------------
# box helpers and batched IoUs
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_box_helpers_bit_equal(seed):
    rng = np.random.default_rng(seed)
    a, b = _seeded_boxes(rng, 24), _seeded_boxes(rng, 17)
    for fin in FORMATS:
        for fout in FORMATS:
            _assert_bits(thelpers.box_convert(torch.from_numpy(a), fin, fout), jhelpers.box_convert(jnp.asarray(a), fin, fout), f"{fin}->{fout}")
    _assert_bits(thelpers.box_area(torch.from_numpy(a)), jhelpers.box_area(jnp.asarray(a)), "area")
    _assert_bits(thelpers.box_iou(torch.from_numpy(a), torch.from_numpy(b)), jhelpers.box_iou(jnp.asarray(a), jnp.asarray(b)), "iou")
    # empty sets on either side
    empty = np.zeros((0, 4), np.float32)
    _assert_bits(thelpers.box_iou(torch.from_numpy(empty), torch.from_numpy(b)), jhelpers.box_iou(jnp.asarray(empty), jnp.asarray(b)), "empty")
    _assert_bits(thelpers.box_iou(torch.from_numpy(a), torch.from_numpy(empty)), jhelpers.box_iou(jnp.asarray(a), jnp.asarray(empty)), "empty2")


def test_box_iou_flushes_denormals_as_xla():
    """A box whose area is a denormal has IoU 0, as XLA's flushed arithmetic
    gives it."""
    a = np.array([[0.0, 0.0, 1e-20, 1e-20], [0.0, 0.0, 2.0, 2.0]], np.float32)
    b = np.array([[0.0, 0.0, 1e-20, 1e-20], [1.0, 1.0, 3.0, 3.0]], np.float32)
    _assert_bits(thelpers.box_iou(torch.from_numpy(a), torch.from_numpy(b)), jhelpers.box_iou(jnp.asarray(a), jnp.asarray(b)), "denormal")


def test_box_convert_refuses_unknown_formats():
    with pytest.raises(ValueError, match="Unsupported"):
        thelpers.box_convert(torch.zeros(1, 4), "xxyy")
    with pytest.raises(ValueError, match="Unsupported"):
        thelpers.box_convert(torch.zeros(1, 4), "xyxy", "xxyy")


@pytest.mark.parametrize("seed", range(2))
def test_batched_box_iou_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n, d, g = 6, 8, 5
    det = np.stack([_seeded_boxes(rng, d) for _ in range(n)])
    gt = np.stack([_seeded_boxes(rng, g) for _ in range(n)])
    det[2], gt[4, 3:] = 0.0, 0.0  # all-pad rows and pad columns
    _assert_bits(tmatcher.batched_box_iou(torch.from_numpy(det), torch.from_numpy(gt)), jmatcher.batched_box_iou(jnp.asarray(det), jnp.asarray(gt)), "batched")


def test_batched_mask_iou_bit_equal():
    rng = np.random.default_rng(3)
    det = (rng.random((4, 6, 300)) < 0.3).astype(np.uint8)
    gt = (rng.random((4, 3, 300)) < 0.4).astype(np.uint8)
    det[1] = 0  # an all-pad cell
    gt[2, :, 150:] = 0  # a smaller mask flatten-padded
    _assert_bits(tmatcher.batched_mask_iou(torch.from_numpy(det), torch.from_numpy(gt)), jmatcher.batched_mask_iou(jnp.asarray(det), jnp.asarray(gt)), "mask")


def test_next_pow2():
    assert [tmatcher.next_pow2(n) for n in (0, 1, 2, 3, 8, 9, 1000)] == [jmatcher.next_pow2(n) for n in (0, 1, 2, 3, 8, 9, 1000)]


# ----------------------------------------------------------------------
# the greedy matcher
# ----------------------------------------------------------------------


def _cells(rng, n, d, g, a=4):
    """Seeded padded cells: IoUs on a coarse grid (ties), a duplicated gt
    column (equal IoUs), ignored gts, and an all-pad cell."""
    ious = (rng.integers(0, 9, (n, d, g)) / 8.0).astype(np.float32)
    ious[:, :, 1] = ious[:, :, 0]  # a duplicate ground truth
    det_valid = rng.random((n, d)) < 0.85
    gt_valid = rng.random((n, g)) < 0.85
    det_valid[0], gt_valid[0] = False, False  # all-pad rows
    gt_ig = rng.random((n, a, g)) < 0.3
    return ious, det_valid, gt_valid, gt_ig


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("thrs", [np.linspace(0.5, 0.95, 10), np.array([0.0, 0.25, 0.5, 0.75, 1.0])], ids=["coco", "edges"])
def test_match_cells_bit_equal(seed, thrs):
    """Equal IoUs, ignored gts, a gt matched at one threshold and free at
    another, all-pad rows, thresholds of 0.0 and 1.0: the matches and the
    matched-to-ignored flags equal JAX's."""
    rng = np.random.default_rng(seed)
    ious, dv, gv, gi = _cells(rng, 7, 9, 6)
    thrs = thrs.astype(np.float32)
    tm, tig = tmatcher.match_cells(*(torch.from_numpy(x) for x in (ious, dv, gv, gi, thrs)))
    jm, jig = jmatcher.match_cells(*(jnp.asarray(x) for x in (ious, dv, gv, gi, thrs)))
    _assert_bits(tm, jm, "matches")
    _assert_bits(tig, jig, "ignored")
    # and against the plain per-cell greedy loop in pycocotools' order
    for c in range(ious.shape[0]):
        for area in range(gi.shape[1]):
            em, ei = _oracle(ious[c], dv[c], gv[c], gi[c, area], thrs)
            np.testing.assert_array_equal(tm[c, area].numpy(), em)
            np.testing.assert_array_equal(tig[c, area].numpy(), ei)


def test_match_cells_without_detections():
    out = tmatcher.match_cells(torch.zeros(2, 0, 3), torch.zeros(2, 0, dtype=torch.bool), torch.ones(2, 3, dtype=torch.bool),
                               torch.zeros(2, 4, 3, dtype=torch.bool), torch.tensor([0.5]))
    assert [tuple(t.shape) for t in out] == [(2, 4, 1, 0), (2, 4, 1, 0)]


# ----------------------------------------------------------------------
# MeanAveragePrecision against the JAX package
# ----------------------------------------------------------------------


def _run_both(updates, **kwargs):
    jm = JMAP(**kwargs)
    tm = TMAP(device="cpu", **kwargs)
    for preds, target in updates:
        jm.update(preds, target)
        tm.update(preds, target)
    return _quiet(jm.compute), _quiet(tm.compute), jm, tm


def _assert_outputs_equal(jr, tr):
    assert set(jr) == set(tr)
    for k in jr:
        _assert_bits(tr[k], jr[k], k)


_BOX = np.array([[258.0, 41.0, 606.0, 285.0]], np.float32)
_GT = np.array([[214.0, 41.0, 562.0, 285.0]], np.float32)
_EMPTY_P = dict(boxes=np.zeros((0, 4), np.float32), scores=np.zeros(0, np.float32), labels=np.zeros(0, np.int64))
_EMPTY_T = dict(boxes=np.zeros((0, 4), np.float32), labels=np.zeros(0, np.int64))


def _segm_masks():
    m1 = np.zeros((1, 10, 10), bool)
    m1[0, :5, :5] = True
    m2 = np.zeros((1, 10, 10), bool)
    m2[0, :5, :] = True
    return m1, m2


def _case(name):
    """``(kwargs, updates)`` of each case of ``tests/detection/test_map.py``."""
    one = [([dict(boxes=_BOX, scores=np.array([0.536], np.float32), labels=np.array([0]))], [dict(boxes=_GT, labels=np.array([0]))])]
    m1, m2 = _segm_masks()
    small, big = np.zeros((1, 8, 8), bool), np.zeros((1, 32, 32), bool)
    small[0, :4, :4], big[0, :16, :16] = True, True
    box = np.array([[10, 20, 15, 25]], np.float32)
    lab = np.array([0])
    good_p = dict(boxes=box, scores=np.array([0.9], np.float32), labels=lab)
    pred_mask = np.arange(100).reshape(1, 10, 10) % 7 == 0
    cases = {
        "coco_sample": ({"class_metrics": True}, list(zip(_PREDS, _TARGET))),
        "single_box": ({}, one),
        "false_negative_only": ({}, [([_EMPTY_P], [dict(boxes=np.array([[1.0, 2.0, 3.0, 4.0]], np.float32), labels=np.array([1]))])]),
        "fp_in_image_without_gt": ({}, [([dict(boxes=_BOX, scores=np.array([0.536], np.float32), labels=np.array([0]))] * 2,
                                         [dict(boxes=_GT, labels=np.array([0])), _EMPTY_T])]),
        "segm_perfect": ({"iou_type": "segm"}, [([dict(masks=m1, scores=np.array([0.9], np.float32), labels=np.array([0]))], [dict(masks=m1.copy(), labels=np.array([0]))])]),
        "segm_half": ({"iou_type": "segm", "iou_thresholds": [0.4, 0.6]},
                      [([dict(masks=m2, scores=np.array([0.9], np.float32), labels=np.array([0]))], [dict(masks=m1.copy(), labels=np.array([0]))])]),
        "xywh": ({"box_format": "xywh"}, [([dict(boxes=np.array([[258.0, 41.0, 348.0, 244.0]], np.float32), scores=np.array([0.536], np.float32), labels=np.array([0]))],
                                           [dict(boxes=np.array([[214.0, 41.0, 348.0, 244.0]], np.float32), labels=np.array([0]))])]),
        "cxcywh": ({"box_format": "cxcywh"}, [([dict(boxes=np.array([[432.0, 163.0, 348.0, 244.0]], np.float32), scores=np.array([0.536], np.float32), labels=np.array([0]))],
                                               [dict(boxes=np.array([[388.0, 163.0, 348.0, 244.0]], np.float32), labels=np.array([0]))])]),
        "segm_mixed_resolutions": ({"iou_type": "segm"}, [
            ([dict(masks=small, scores=np.array([0.9], np.float32), labels=np.array([0]))], [dict(masks=small.copy(), labels=np.array([0]))]),
            ([dict(masks=big, scores=np.array([0.8], np.float32), labels=np.array([0]))], [dict(masks=big.copy(), labels=np.array([0]))])]),
        "empty_metric": ({}, []),
        "missing_pred": ({}, [([good_p, _EMPTY_P], [dict(boxes=box, labels=lab), dict(boxes=box, labels=lab)])]),
        "missing_gt": ({}, [([good_p, dict(boxes=box, scores=np.array([0.95], np.float32), labels=lab)], [dict(boxes=box, labels=lab), _EMPTY_T])]),
        "custom_iou_thresholds": ({"iou_thresholds": [0.1, 0.2]}, one),
        "custom_rec_and_max_det": ({"rec_thresholds": [0.0, 0.5, 1.0], "max_detection_thresholds": [2, 1]}, list(zip(_PREDS, _TARGET))),
        "segm_empty_gt": ({"iou_type": "segm"}, [([dict(masks=pred_mask, scores=np.array([0.5], np.float32), labels=np.array([4]))],
                                                 [dict(masks=np.zeros((0, 10, 10), bool), labels=np.zeros(0, np.int64))])]),
        "segm_empty_pred": ({"iou_type": "segm"}, [([dict(masks=np.zeros((0, 10, 10), bool), scores=np.zeros(0, np.float32), labels=np.zeros(0, np.int64))],
                                                   [dict(masks=pred_mask, labels=np.array([4]))])]),
    }
    return cases[name]


_CASES = ["coco_sample", "single_box", "false_negative_only", "fp_in_image_without_gt", "segm_perfect", "segm_half", "xywh", "cxcywh",
          "segm_mixed_resolutions", "empty_metric", "missing_pred", "missing_gt", "custom_iou_thresholds", "custom_rec_and_max_det",
          "segm_empty_gt", "segm_empty_pred"]


@pytest.mark.parametrize("name", _CASES)
def test_map_cases_equal_jax(name):
    kwargs, updates = _case(name)
    jr, tr, _, _ = _run_both(updates, **kwargs)
    _assert_outputs_equal(jr, tr)


def test_map_states_mirror_jax():
    """Each image's rows in JAX's five states, on the metric's device, plus
    the port's ``image_sizes`` (D60)."""
    _, _, jm, tm = _run_both(list(zip(_PREDS, _TARGET)))
    for name in ("detections", "detection_scores", "detection_labels", "groundtruths", "groundtruth_labels"):
        jitems, titems = getattr(jm, name), getattr(tm, name)
        assert len(jitems) == len(titems) == 4
        for j, t in zip(jitems, titems):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert torch.cat(tm.image_sizes)[:, :2].tolist() == [[1, 1], [2, 2], [7, 7], [1, 1]]


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("class_metrics", [False, True])
def test_map_coco_shaped_set_equal_jax(iou_type, class_metrics):
    """A seeded 64-image COCO-shaped set, 16 images an update: every output
    bit-equal to JAX's (``segm`` at two resolutions, 96x128 and 128x96)."""
    shapes = ((96, 128), (128, 96)) if iou_type == "segm" else ((480, 640), (640, 480))
    preds, targets = R.coco_like(64, 11, segm=iou_type == "segm", shapes=shapes)
    updates = [(preds[s:s + 16], targets[s:s + 16]) for s in range(0, 64, 16)]
    jr, tr, _, _ = _run_both(updates, iou_type=iou_type, class_metrics=class_metrics)
    _assert_outputs_equal(jr, tr)
    assert 0.0 < float(tr["map"]) < 1.0


def test_map_tensor_inputs_equal_numpy_inputs():
    preds, targets = R.coco_like(12, 5)
    as_tensors = lambda items: [{k: torch.from_numpy(v) for k, v in d.items()} for d in items]  # noqa: E731
    a, b = TMAP(device="cpu"), TMAP(device="cpu")
    a.update(preds, targets)
    b.update(as_tensors(preds), as_tensors(targets))
    _assert_outputs_equal(_quiet(a.compute), _quiet(b.compute))


def test_map_input_validation_as_jax():
    m = TMAP(device="cpu")
    with pytest.raises(ValueError, match="same length"):
        m.update([], [_EMPTY_T])
    with pytest.raises(ValueError, match="boxes"):
        m.update([dict(scores=np.zeros(0, np.float32), labels=np.zeros(0, np.int64))], [_EMPTY_T])
    with pytest.raises(ValueError, match="different length"):
        m.update([dict(boxes=_BOX, scores=np.zeros(2, np.float32), labels=np.array([0]))], [dict(boxes=_GT, labels=np.array([0]))])
    for kwargs, match in (({"box_format": "xxyy"}, "box_format"), ({"iou_type": "mask"}, "iou_type"), ({"class_metrics": "yes"}, "class_metrics")):
        with pytest.raises(ValueError, match=match):
            TMAP(device="cpu", **kwargs)


# ----------------------------------------------------------------------
# F12: image boundaries through a sync (D60)
# ----------------------------------------------------------------------


def _witness():
    """Two images: a detection in the first, its ground truth in the second."""
    box = np.array([[10, 10, 50, 50]], np.float32)
    preds = [dict(boxes=box, scores=np.array([0.9], np.float32), labels=np.array([0])), _EMPTY_P]
    return preds, [_EMPTY_T, dict(boxes=box, labels=np.array([0]))]


@pytest.mark.reference_fault
def test_jax_map_sync_loses_image_boundaries():
    """ROADMAP F12 (reference-side): the JAX package's sync concatenates each
    list state's items, so after a sync of a world of one ``groundtruths``
    holds one array and the detection of image 0 matches the ground truth
    of image 1: map reads 1.0 where the unsynced metric reads 0.0."""
    preds, target = _witness()
    jm = JMAP()
    jm.update(preds, target)
    assert float(_quiet(jm.compute)["map"]) == 0.0
    synced = JMAP()
    synced.update(preds, target)
    synced._sync_dist(dist_sync_fn=lambda x, group=None: [x])
    assert len(synced.groundtruths) == 1
    assert float(_quiet(synced.compute)["map"]) == 1.0
    assert float(_quiet(synced.compute)["mar_100"]) == 1.0


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_twin_world_sync_keeps_image_boundaries(iou_type):
    """D60 in a fake two-rank world (the other rank holds the same images):
    the synced compute equals one process over the images twice, with one
    header and one payload gather per list state and nothing else."""
    if iou_type == "bbox":
        preds, targets = _witness()
        more_p, more_t = R.coco_like(6, 2)
        preds, targets = preds + more_p, targets + more_t
    else:
        preds, targets = R.coco_like(6, 2, segm=True, shapes=R.SEGM_SHAPES)
    tm = TMAP(iou_type=iou_type, device="cpu")
    tm.update(preds, targets)
    twice = TMAP(iou_type=iou_type, device="cpu")
    twice.update(preds + preds, targets + targets)
    world = TwinWorld()
    tm.sync(dist_sync_fn=world, distributed_available_fn=lambda: True)
    synced = _quiet(tm._original_compute)
    tm.unsync()
    _assert_outputs_equal(_quiet(twice._original_compute), synced)
    assert [c[0] for c in world.calls] == ["all_gather"] * 12
    assert len(tm.image_sizes) == len(preds)  # the local state is kept


def _one_process(segm):
    preds, targets = R.world_data(segm)
    m = TMAP(iou_type="segm" if segm else "bbox", class_metrics=True, device="cpu")
    for lo, hi in R.RANK_IMAGES:  # the images in rank order, as the sync gathers them
        m.update(preds[lo:hi], targets[lo:hi])
    return _quiet(m.compute)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    n = 2
    out = {}
    for segm in (False, True):
        store = tmp_path_factory.mktemp(f"map2-{segm}") / "store"
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=R.rank_main, args=(r, n, str(store), queue, segm)) for r in range(n)]
        for proc in procs:
            proc.start()
        try:
            results = dict(queue.get(timeout=240) for _ in procs)
        finally:
            for proc in procs:
                proc.join(timeout=60)
                if proc.is_alive():
                    proc.kill()
        for r, res in sorted(results.items()):
            if "error" in res:
                pytest.fail(f"rank {r} of {n} failed:\n{res['error']}")
        assert [proc.exitcode for proc in procs] == [0] * n
        out[segm] = [results[r] for r in range(n)]
    return out


@pytest.mark.parametrize("segm", [False, True], ids=["bbox", "segm"])
def test_two_ranks_give_the_one_process_values(world2, segm):
    """D60: two Gloo ranks (``segm``: masks of 48x64 and 64x48) compute the
    one-process values over every image in rank order, bit for bit, with the
    collectives of six list states (a header and a payload gather each)."""
    want = _one_process(segm)
    for r in world2[segm]:
        assert r["jax_loaded"] == []
        assert r["calls"] == [("all_gather",)] * 12
        assert set(r["value"]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(r["value"][k], v.numpy(), err_msg=k)
    assert [r["local_images"] for r in world2[segm]] == [hi - lo for lo, hi in R.RANK_IMAGES]
