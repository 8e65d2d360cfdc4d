"""COCO-style mean Average Precision / Recall (counterpart of
``metrics_tpu/detection/mean_ap.py``).

The states are per-image list states on the metric's device, as in the JAX
package (boxes ``(n, 4)`` float32 in xyxy, or masks ``(n, h, w)`` bool,
with the scores and labels). ``compute`` reads them back once (not once
per image), builds one cell per (image, class with content) on the host,
matches every cell on the device (``detection/matcher.py``: IoUs and the
greedy scan, batched) and accumulates precision and recall on the host in
float64 numpy, in the JAX package's order, so that every output equals
JAX's. For ``iou_type="segm"`` the masks never leave the device: their
areas are summed there, and each matcher batch gathers its padded masks
there.

**Image boundaries survive a sync (ROADMAP F12, D60).** A list state syncs
to the concatenation of every rank's rows, so the JAX package's synced
``groundtruths`` holds one array per rank, and its cells then treat a
rank's images as one image: a detection can match a ground truth of
another image, and ``max_detection_thresholds`` caps a whole rank. Here a
sixth list state, ``image_sizes``, keeps each image's row
``(n_det, n_gt, det_h, det_w, gt_h, gt_w)``; the rows sync in the same
ragged gathers as the others, and ``compute`` splits the synced rows back
into images. Masks sync flattened (``_state_for_sync``), so images of
different resolutions concatenate. A metric that never syncs keeps the
JAX package's values bit for bit.
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.detection.helpers import box_convert
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs import trace as _obs_trace

Tensor = torch.Tensor

__all__ = ["MeanAveragePrecision"]

def _rows(x: Any) -> int:
    return int(x.shape[0]) if hasattr(x, "shape") else int(np.asarray(x).shape[0])


def _input_validator(preds: Sequence[Dict[str, Any]], targets: Sequence[Dict[str, Any]], iou_type: str = "bbox") -> None:
    """Validate the list-of-dicts input contract (the JAX package's rules)."""
    item_key = "boxes" if iou_type == "bbox" else "masks"
    if not isinstance(preds, Sequence):
        raise ValueError("Expected argument `preds` to be of type Sequence")
    if not isinstance(targets, Sequence):
        raise ValueError("Expected argument `target` to be of type Sequence")
    if len(preds) != len(targets):
        raise ValueError("Expected argument `preds` and `target` to have the same length")

    for k in (item_key, "scores", "labels"):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in (item_key, "labels"):
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    for i, item in enumerate(preds):
        n = _rows(item[item_key])
        if _rows(item["scores"]) != n or _rows(item["labels"]) != n:
            raise ValueError(
                f"Input {item_key} scores and labels of sample {i} in predictions have a different length"
            )
    for i, item in enumerate(targets):
        if _rows(item[item_key]) != _rows(item["labels"]):
            raise ValueError(f"Input {item_key} and labels of sample {i} in targets have a different length")


def _host_or_tensor(x: Any) -> Any:
    return x if isinstance(x, Tensor) else np.asarray(x)


class MeanAveragePrecision(Metric):
    """COCO mAP / mAR.

    Accepts per-image prediction dicts (``boxes``/``scores``/``labels`` —
    ``masks`` instead of boxes for ``iou_type="segm"``) and target dicts
    (``boxes``/``labels``), as tensors or numpy arrays, keeps them as
    per-image list states on the metric's device, and computes the full COCO
    summary at 10 IoU thresholds, 101 recall points, 4 area ranges and 3
    max-detection caps.

    Example:
        >>> import torch
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 50.0, 50.0]]),
        ...           "scores": torch.tensor([0.9]), "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[10.0, 10.0, 50.0, 50.0]]), "labels": torch.tensor([0])}]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["map"]), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = True
    # per-image lists of ragged rows: nothing to capture
    jittable_update = False

    # matcher batch chunk: bounds device memory at COCO scale (16384 cells
    # of 8 dets x 10 thresholds x 64 gts is 84 MB a mask); the JAX package
    # takes 1024 (D61): a step is a dozen launches whatever the batch, so
    # fewer, larger batches take fewer steps
    _MATCH_CHUNK = 16384
    # padded (det + gt) flattened-mask bytes allowed per segm matcher batch
    _MASK_BYTES_BUDGET = 1 << 30  # 1 GB (the JAX package takes 256 MB, D61)

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: str = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"Expected argument `iou_type` to be one of ('segm', 'bbox') but got {iou_type}")
        self.iou_type = iou_type
        self.iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, 10).tolist()
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.0, 101).tolist()
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        self.bbox_area_ranges = {
            "all": (0**2, int(1e5**2)),
            "small": (0**2, 32**2),
            "medium": (32**2, 96**2),
            "large": (96**2, int(1e5**2)),
        }

        # boxes sync as (n, 4) float32 rows, masks flattened to uint8
        # (`_state_for_sync`): images of different resolutions concatenate
        item_template = torch.zeros((0, 4), dtype=torch.float32) if iou_type == "bbox" else torch.zeros((0,), dtype=torch.uint8)
        self.add_state("detections", default=[], dist_reduce_fx=None, template=item_template)
        self.add_state("detection_scores", default=[], dist_reduce_fx=None, template=torch.zeros((0,), dtype=torch.float32))
        self.add_state("detection_labels", default=[], dist_reduce_fx=None, template=torch.zeros((0,), dtype=torch.int64))
        self.add_state("groundtruths", default=[], dist_reduce_fx=None, template=item_template)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None, template=torch.zeros((0,), dtype=torch.int64))
        # F12: each image's (n_det, n_gt, det_h, det_w, gt_h, gt_w), which
        # splits the synced rows back into images (D60)
        self.add_state("image_sizes", default=[], dist_reduce_fx=None, template=torch.zeros((0, 6), dtype=torch.int64))

    # ---- update ----------------------------------------------------------

    def update(self, preds: Sequence[Dict[str, Any]], target: Sequence[Dict[str, Any]]) -> None:
        _input_validator(preds, target, iou_type=self.iou_type)
        item_key = "boxes" if self.iou_type == "bbox" else "masks"
        det_items = [_host_or_tensor(p[item_key]) for p in preds]
        gt_items = [_host_or_tensor(t[item_key]) for t in target]
        sizes = [
            [_rows(d), _rows(g), *self._item_hw(d), *self._item_hw(g)] for d, g in zip(det_items, gt_items)
        ]
        self.detections.extend(self._items_to_device(det_items))
        self.detection_labels.extend(self._device_items([_host_or_tensor(p["labels"]) for p in preds], torch.int64))
        self.detection_scores.extend(self._device_items([_host_or_tensor(p["scores"]) for p in preds], torch.float32))
        self.groundtruths.extend(self._items_to_device(gt_items))
        self.groundtruth_labels.extend(self._device_items([_host_or_tensor(t["labels"]) for t in target], torch.int64))
        if sizes:
            rows = torch.as_tensor(np.asarray(sizes, dtype=np.int64)).to(self.device)
            self.image_sizes.extend(rows.split(1))

    def _item_hw(self, item: Any) -> Tuple[int, int]:
        if self.iou_type == "segm" and len(item.shape) == 3:
            return int(item.shape[1]), int(item.shape[2])
        return 0, 0

    def _device_items(self, arrays: List[Any], dtype: torch.dtype, shapes: Optional[List[Tuple[int, ...]]] = None) -> List[Tensor]:
        """Per-image arrays as flat-then-reshaped tensors of ``dtype`` on the
        metric's device: host arrays in one host-to-device copy (views of
        one tensor), tensors each moved."""
        if shapes is None:
            shapes = [(int(np.prod(a.shape)),) for a in arrays]
        if arrays and all(isinstance(a, np.ndarray) for a in arrays):
            flat = np.concatenate([a.reshape(-1) for a in arrays]).astype(torch.empty((), dtype=dtype).numpy().dtype)
            dev = torch.from_numpy(flat).to(self.device)
            return [v.view(s) for v, s in zip(dev.split([int(np.prod(s)) for s in shapes]), shapes)]
        return [torch.as_tensor(a).to(self.device).to(dtype).reshape(s) for a, s in zip(arrays, shapes)]

    def _items_to_device(self, items: List[Any]) -> List[Tensor]:
        """Boxes as float32 xyxy ``(n, 4)`` (an empty set as ``(0, 4)``),
        converted from ``box_format`` on the device; masks as bool."""
        if self.iou_type == "segm":
            return self._device_items(items, torch.bool, [tuple(a.shape) for a in items])
        shapes = [(_rows(a) if int(np.prod(a.shape)) else 0, 4) for a in items]
        boxes = self._device_items(items, torch.float32, shapes)
        if self.box_format == "xyxy" or not boxes:
            return boxes
        # one conversion for the update's boxes, rows kept per image
        converted = box_convert(torch.cat(boxes), in_fmt=self.box_format, out_fmt="xyxy")
        return list(converted.split([s[0] for s in shapes]))

    def _state_for_sync(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Masks flattened to uint8, so that images of different resolutions
        concatenate in the gather (new lists; the state is kept)."""
        state = dict(super()._state_for_sync(state))
        if self.iou_type == "segm":
            for name in ("detections", "groundtruths"):
                if isinstance(state[name], list):
                    state[name] = [t.reshape(-1).to(torch.uint8) for t in state[name]]
        return state

    # ---- evaluation ------------------------------------------------------

    def _state_rows(self, name: str) -> Tensor:
        """A state's rows as one tensor: the concatenated items (an update's,
        or each rank's after a sync)."""
        value = getattr(self, name)
        if isinstance(value, Tensor):
            return value
        if self.iou_type == "segm" and name in ("detections", "groundtruths"):
            value = [t.reshape(-1).to(torch.uint8) for t in value]
        return torch.cat(value) if value else self._list_templates[name]

    def _image_masks(self, name: str, n: np.ndarray, hw: np.ndarray) -> List[Tensor]:
        """Each image's masks as an ``(n, h*w)`` view on the device: the
        update's bool items themselves, or the synced flat uint8 rows (one
        tensor per rank) split back into images."""
        value = getattr(self, name)
        if not (isinstance(value, list) and all(t.dtype == torch.bool for t in value)):
            value = self._state_rows(name).reshape(-1).split((n * hw).tolist())
        return [m.reshape(int(k), int(p)) for m, k, p in zip(value, n, hw)]

    def _host_images(self) -> Dict[str, Any]:
        """Every image's rows on the host as flat arrays, read back once per
        state (masks stay on the device: their areas are read instead, and
        each image's masks are an ``(n, h*w)`` view)."""
        sizes = self._state_rows("image_sizes").reshape(-1, 6).cpu().numpy()
        nd, ng = sizes[:, 0], sizes[:, 1]
        n_images = sizes.shape[0]
        out: Dict[str, Any] = {
            "det_img": np.repeat(np.arange(n_images), nd),
            "gt_img": np.repeat(np.arange(n_images), ng),
            "scores": self._state_rows("detection_scores").cpu().numpy().reshape(-1),
            "labels": self._state_rows("detection_labels").cpu().numpy().reshape(-1),
            "gt_labels": self._state_rows("groundtruth_labels").cpu().numpy().reshape(-1),
        }
        if self.iou_type == "bbox":
            for side, name in (("det", "detections"), ("gt", "groundtruths")):
                boxes = self._state_rows(name).reshape(-1, 4).cpu().numpy()
                out[side] = boxes
                out[f"{side}_areas"] = self._box_area(boxes)
            return out
        for side, n, hw in (("det", nd, sizes[:, 2] * sizes[:, 3]), ("gt", ng, sizes[:, 4] * sizes[:, 5])):
            masks = self._image_masks("detections" if side == "det" else "groundtruths", n, hw)
            areas = [m.sum(-1) for m in masks]
            out[side] = masks
            out[f"{side}_hw"] = hw
            out[f"{side}_areas"] = (torch.cat(areas).cpu().numpy() if areas else np.zeros(0, np.int64)).astype(np.float64)
            # each row's index within its image's masks
            out[f"{side}_row"] = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        return out

    def _get_classes(self, images: Dict[str, Any]) -> List[int]:
        labels = np.concatenate([images["labels"], images["gt_labels"]])
        return sorted(np.unique(labels).astype(int).tolist()) if labels.size else []

    @staticmethod
    def _box_area(items: np.ndarray) -> np.ndarray:
        # host numpy: areas feed the accumulate stage and the ignore masks
        return (items[:, 2] - items[:, 0]) * (items[:, 3] - items[:, 1])

    def _build_cells(self, class_ids: List[int], max_det: int, images: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """One cell per (image, class-with-content), as flat arrays: the JAX
        package's per-(image, class) preparation (label filter, stable
        score-descending sort, the largest max_det kept), over every image
        at once. The cells are in JAX's order (images, then classes); the
        kept detections (``det_*``) and the ground truths (``gt_*``) are in
        cell order, each with its cell and its rank inside it. Area ranges
        only change ignore masks downstream, so cells are area-independent."""
        classes = np.asarray(class_ids, np.int64)
        n_cls = max(len(class_ids), 1)

        def groups(key: np.ndarray) -> np.ndarray:
            """Each sorted row's rank inside its run of equal keys."""
            if not key.size:
                return np.zeros(0, np.int64)
            new = np.r_[True, key[1:] != key[:-1]]
            starts = np.flatnonzero(new)
            return np.arange(key.size) - starts[np.cumsum(new) - 1]

        # detections: by image, then label, then score descending (stable)
        d_order = np.lexsort((-images["scores"], images["labels"], images["det_img"]))
        d_key = images["det_img"][d_order] * n_cls + np.searchsorted(classes, images["labels"][d_order])
        d_rank = groups(d_key)
        kept = d_rank < max_det
        # ground truths: by image, then label (stable)
        g_order = np.lexsort((images["gt_labels"], images["gt_img"]))
        g_key = images["gt_img"][g_order] * n_cls + np.searchsorted(classes, images["gt_labels"][g_order])
        keys = np.union1d(d_key[kept], g_key)
        det_cell = np.searchsorted(keys, d_key[kept])
        gt_cell = np.searchsorted(keys, g_key)
        nd = np.bincount(det_cell, minlength=keys.size)
        ng = np.bincount(gt_cell, minlength=keys.size)
        return {
            "cls": keys % n_cls, "image": keys // n_cls, "nd": nd, "ng": ng,
            "det_start": np.cumsum(nd) - nd, "gt_start": np.cumsum(ng) - ng,
            "det_idx": d_order[kept], "det_rank": d_rank[kept], "det_cell": det_cell,
            "gt_idx": g_order, "gt_rank": groups(g_key), "gt_cell": gt_cell,
        }

    def _match_all_cells(
        self, cells: Dict[str, np.ndarray], area_ranges: np.ndarray, images: Dict[str, Any]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run the device matcher over every cell. Returns the kept
        detections' matches ``m (A, T, n_det)`` and matched-to-ignored
        ``ig (A, T, n_det)`` (cell order), and the ground truths' area
        ignores ``(A, n_gt)``.

        Cells are bucketed by detection count (power-of-two caps, at least
        8): the greedy scan's length is the detection axis, so a cell with
        6 dets in a 128-cap batch would pay 128 steps for 6 rows of work.
        Each batch's padded arrays are gathered from the flat rows at once."""
        from metrics_tpu_torch.detection.matcher import batched_box_iou, batched_mask_iou, match_cells, next_pow2

        nb_areas, nb_thrs = area_ranges.shape[0], len(self.iou_thresholds)
        device = self.device
        thrs = torch.tensor(self.iou_thresholds, dtype=torch.float32, device=device)
        segm = self.iou_type == "segm"

        def upload(arr: np.ndarray) -> Tensor:
            # pinned and asynchronous on the card: the host pads the next
            # batch while the device matches this one
            t = torch.from_numpy(np.ascontiguousarray(arr))
            return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t

        nd, ng = cells["nd"], cells["ng"]
        gt_areas = images["gt_areas"][cells["gt_idx"]]
        # single source for the gt area-ignore mask: matcher input here,
        # npig accumulation in _calculate
        gt_ig_all = (gt_areas[None, :] < area_ranges[:, :1]) | (gt_areas[None, :] > area_ranges[:, 1:])
        n_det = cells["det_idx"].size
        matches = np.zeros((nb_areas, nb_thrs, n_det), bool)
        ignored = np.zeros((nb_areas, nb_thrs, n_det), bool)
        if not nd.size:
            return matches, ignored, gt_ig_all
        if segm:
            det_rows = upload(images["det_row"][cells["det_idx"]])
            gt_rows = upload(images["gt_row"][cells["gt_idx"]])
        else:
            det_boxes_all = images["det"][cells["det_idx"]]
            gt_boxes_all = images["gt"][cells["gt_idx"]]

        def runs(batch: np.ndarray, counts: np.ndarray, starts: np.ndarray):
            """(batch row, rank, flat index) of every element of the cells."""
            c = counts[batch]
            k = np.repeat(np.arange(batch.size), c)
            r = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
            return k, r, np.repeat(starts[batch], c) + r

        caps = np.maximum(8, [next_pow2(n) for n in nd])
        in_flight = []  # dispatch everything, fetch at the end
        for d_cap in np.unique(caps):
            idxs = np.flatnonzero(caps == d_cap)
            d_cap = int(d_cap)
            g_cap = next_pow2(int(ng[idxs].max()))
            chunk = min(self._MATCH_CHUNK, next_pow2(idxs.size))
            if segm:
                # one flattened-pixel cap per bucket, the largest mask itself
                # (zero padding changes no IoU), and a batch size bounded so
                # the padded mask tensors stay within the memory budget
                img = cells["image"][idxs]
                hws = np.concatenate([images["det_hw"][img][nd[idxs] > 0], images["gt_hw"][img][ng[idxs] > 0]])
                hw_cap = int(hws.max()) if hws.size else 1
                per_cell_bytes = (d_cap + g_cap) * hw_cap * 4
                chunk = min(chunk, max(1, next_pow2(self._MASK_BYTES_BUDGET // per_cell_bytes + 1) // 2))
            for start in range(0, idxs.size, chunk):
                batch = idxs[start : start + chunk]
                rows = batch.size
                kd, rd, src_d = runs(batch, nd, cells["det_start"])
                kg, rg, src_g = runs(batch, ng, cells["gt_start"])
                det_valid = np.zeros((rows, d_cap), bool)
                gt_valid = np.zeros((rows, g_cap), bool)
                gt_ig = np.zeros((rows, nb_areas, g_cap), bool)
                det_valid[kd, rd] = True
                gt_valid[kg, rg] = True
                gt_ig[kg, :, rg] = gt_ig_all[:, src_g].T
                if segm:
                    det_masks = torch.zeros((rows, d_cap, hw_cap), dtype=torch.uint8, device=device)
                    gt_masks = torch.zeros((rows, g_cap, hw_cap), dtype=torch.uint8, device=device)
                    for k, j in enumerate(batch):
                        # flatten-pad: each cell fills its own H*W prefix;
                        # zero pixels are IoU-neutral (batched_mask_iou)
                        i = cells["image"][j]
                        for masks, n, s, src, src_rows in (
                            (det_masks, nd[j], cells["det_start"][j], images["det"], det_rows),
                            (gt_masks, ng[j], cells["gt_start"][j], images["gt"], gt_rows),
                        ):
                            if n:
                                masks[k, :n, : src[i].shape[1]] = src[i].index_select(0, src_rows[s : s + n])
                    ious = batched_mask_iou(det_masks, gt_masks)
                else:
                    det_boxes = np.zeros((rows, d_cap, 4), np.float32)
                    gt_boxes = np.zeros((rows, g_cap, 4), np.float32)
                    det_boxes[kd, rd] = det_boxes_all[src_d]
                    gt_boxes[kg, rg] = gt_boxes_all[src_g]
                    ious = batched_box_iou(upload(det_boxes), upload(gt_boxes))
                m, ig = match_cells(ious, upload(det_valid), upload(gt_valid), upload(gt_ig), thrs)
                in_flight.append((kd, rd, src_d, m, ig))
        for kd, rd, src_d, m, ig in in_flight:
            matches[:, :, src_d] = m.cpu().numpy()[kd, :, :, rd].transpose(1, 2, 0)
            ignored[:, :, src_d] = ig.cpu().numpy()[kd, :, :, rd].transpose(1, 2, 0)
        return matches, ignored, gt_ig_all

    def _calculate(self, class_ids: List[int], images: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        """Device-matched precision/recall accumulation over all
        (class, area, max_det) cells, in float64 numpy on the host, in the
        JAX package's order of operations."""
        nb_thrs = len(self.iou_thresholds)
        nb_rec = len(self.rec_thresholds)
        nb_cls = len(class_ids)
        nb_areas = len(self.bbox_area_ranges)
        max_det = self.max_detection_thresholds[-1]
        rec_thrs = np.asarray(self.rec_thresholds)
        area_ranges = np.asarray(list(self.bbox_area_ranges.values()), np.float64)

        precision = -np.ones((nb_thrs, nb_rec, nb_cls, nb_areas, len(self.max_detection_thresholds)))
        recall = -np.ones((nb_thrs, nb_cls, nb_areas, len(self.max_detection_thresholds)))

        with _obs_trace.span("detection.build_cells", metric=type(self).__name__):
            cells = self._build_cells(class_ids, max_det, images)
        if not cells["nd"].size:
            return precision, recall
        with _obs_trace.span("detection.match", metric=type(self).__name__, cells=int(cells["nd"].size)):
            m_all, ig_all, gt_ig_all = self._match_all_cells(cells, area_ranges, images)

        with _obs_trace.span("detection.accumulate", metric=type(self).__name__):
            # host-side ignore completion: unmatched dets outside the area range
            da = images["det_areas"][cells["det_idx"]]
            out = (da[None, :] < area_ranges[:, :1]) | (da[None, :] > area_ranges[:, 1:])  # (A, n_det)
            ig_all |= ~m_all & out[:, None, :]
            det_cls = cells["cls"][cells["det_cell"]]
            gt_cls = cells["cls"][cells["gt_cell"]]
            scores = images["scores"][cells["det_idx"]]
            # non-ignored ground truths a class and area
            npigs = np.stack([np.bincount(gt_cls[~gt_ig_all[a]], minlength=nb_cls) for a in range(nb_areas)], axis=1)
            # each class's dets in cell order (a stable sort by class)
            by_class = np.argsort(det_cls, kind="stable")
            bounds = np.searchsorted(det_cls[by_class], np.arange(nb_cls + 1))
            has_cell = np.bincount(cells["cls"], minlength=nb_cls) > 0

            for idx_cls in range(nb_cls):
                if not has_cell[idx_cls] or not npigs[idx_cls].any():
                    continue  # before the sort work — empty areas stay free
                sel = by_class[bounds[idx_cls] : bounds[idx_cls + 1]]
                # the per-mdet subset of the score-sorted class is selected
                # by each detection's rank inside its cell
                order = np.argsort(-scores[sel], kind="stable")
                pos_sorted = cells["det_rank"][sel][order]
                m_cls = m_all[:, :, sel][:, :, order]
                ig_cls = ig_all[:, :, sel][:, :, order]
                for idx_area in range(nb_areas):
                    npig = int(npigs[idx_cls, idx_area])
                    if npig == 0:
                        continue
                    m_area = m_cls[idx_area]
                    ig_area = ig_cls[idx_area]
                    for idx_mdet, mdet in enumerate(self.max_detection_thresholds):
                        keep = pos_sorted < mdet
                        det_matches = m_area[:, keep]
                        det_ignore = ig_area[:, keep]
                        tps = det_matches & ~det_ignore
                        fps = ~det_matches & ~det_ignore
                        tp_sum = tps.cumsum(axis=1).astype(np.float64)
                        fp_sum = fps.cumsum(axis=1).astype(np.float64)
                        nd = tp_sum.shape[1]
                        rc = tp_sum / npig
                        pr = tp_sum / (fp_sum + tp_sum + np.finfo(np.float64).eps)
                        recall[:, idx_cls, idx_area, idx_mdet] = rc[:, -1] if nd else 0.0
                        # precision envelope: non-increasing from the right
                        pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                        for idx_thr in range(nb_thrs):
                            inds_r = np.searchsorted(rc[idx_thr], rec_thrs, side="left")
                            num_inds = int(inds_r.argmax()) if inds_r.max() >= nd else nb_rec
                            prec = np.zeros(nb_rec)
                            prec[:num_inds] = pr[idx_thr][inds_r[:num_inds]]
                            precision[idx_thr, :, idx_cls, idx_area, idx_mdet] = prec

        return precision, recall

    def _summarize(
        self,
        precision: np.ndarray,
        recall: np.ndarray,
        avg_prec: bool = True,
        iou_threshold: Optional[float] = None,
        area_range: str = "all",
        max_dets: int = 100,
    ) -> float:
        area_idx = list(self.bbox_area_ranges).index(area_range)
        mdet_idx = self.max_detection_thresholds.index(max_dets)
        if avg_prec:
            prec = precision[..., area_idx, mdet_idx]
            if iou_threshold is not None:
                prec = prec[self.iou_thresholds.index(iou_threshold)]
        else:
            prec = recall[..., area_idx, mdet_idx]
            if iou_threshold is not None:
                prec = prec[self.iou_thresholds.index(iou_threshold)]
        valid = prec[prec > -1]
        return float(valid.mean()) if valid.size else -1.0

    def _summarize_results(self, precision: np.ndarray, recall: np.ndarray) -> Dict[str, float]:
        last_mdet = self.max_detection_thresholds[-1]
        res = {
            "map": self._summarize(precision, recall, True, max_dets=last_mdet),
            "map_small": self._summarize(precision, recall, True, area_range="small", max_dets=last_mdet),
            "map_medium": self._summarize(precision, recall, True, area_range="medium", max_dets=last_mdet),
            "map_large": self._summarize(precision, recall, True, area_range="large", max_dets=last_mdet),
            "mar_small": self._summarize(precision, recall, False, area_range="small", max_dets=last_mdet),
            "mar_medium": self._summarize(precision, recall, False, area_range="medium", max_dets=last_mdet),
            "mar_large": self._summarize(precision, recall, False, area_range="large", max_dets=last_mdet),
        }
        res["map_50"] = (
            self._summarize(precision, recall, True, iou_threshold=0.5, max_dets=last_mdet)
            if 0.5 in self.iou_thresholds
            else -1.0
        )
        res["map_75"] = (
            self._summarize(precision, recall, True, iou_threshold=0.75, max_dets=last_mdet)
            if 0.75 in self.iou_thresholds
            else -1.0
        )
        for mdet in self.max_detection_thresholds:
            res[f"mar_{mdet}"] = self._summarize(precision, recall, False, max_dets=mdet)
        return res

    def compute(self) -> Dict[str, Tensor]:
        images = self._host_images()
        classes = self._get_classes(images)
        precision, recall = self._calculate(classes, images)
        results = self._summarize_results(precision, recall)

        map_per_class: Any = [-1.0]
        mar_per_class: Any = [-1.0]
        if self.class_metrics:
            map_per_class = []
            mar_per_class = []
            for idx_cls in range(len(classes)):
                cls_prec = precision[:, :, idx_cls : idx_cls + 1]
                cls_rec = recall[:, idx_cls : idx_cls + 1]
                cls_res = self._summarize_results(cls_prec, cls_rec)
                map_per_class.append(cls_res["map"])
                mar_per_class.append(cls_res[f"mar_{self.max_detection_thresholds[-1]}"])

        values = dict(results)
        # always 1-D, the reference's shape contract (sentinel [-1.])
        values["map_per_class"] = np.asarray(map_per_class, dtype=np.float32)
        values[f"mar_{self.max_detection_thresholds[-1]}_per_class"] = np.asarray(mar_per_class, dtype=np.float32)
        return {k: torch.as_tensor(np.asarray(v, dtype=np.float32)).to(self.device) for k, v in values.items()}
