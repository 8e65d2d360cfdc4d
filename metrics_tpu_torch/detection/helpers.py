"""Box utilities for the detection metrics (counterpart of
``metrics_tpu/detection/helpers.py``).

``box_convert``, ``box_area`` and ``box_iou`` on tensors, in the JAX
package's order of operations (the areas, ``lt``/``rb``, a clamp at 0, the
product, the union, the guarded division), so that the IoUs are bit-equal
to JAX's. Denormals are flushed where XLA's arithmetic flushes them (the
inputs, the products and the union the guard compares), through
``ops/bucketed_rank.py::flush_denormals``.
"""
import torch

from metrics_tpu_torch.ops.bucketed_rank import flush_denormals

Tensor = torch.Tensor

__all__ = ["box_convert", "box_area", "box_iou"]


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str = "xyxy") -> Tensor:
    """Convert ``(N, 4)`` boxes between ``xyxy`` / ``xywh`` / ``cxcywh``."""
    if in_fmt == out_fmt:
        return boxes
    if in_fmt == "xyxy":
        x1, y1, x2, y2 = boxes.unbind(-1)
    elif in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        x1, y1, x2, y2 = x, y, x + w, y + h
    elif in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
    else:
        raise ValueError(f"Unsupported box format {in_fmt}")
    if out_fmt == "xyxy":
        out = (x1, y1, x2, y2)
    elif out_fmt == "xywh":
        out = (x1, y1, x2 - x1, y2 - y1)
    elif out_fmt == "cxcywh":
        out = ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1)
    else:
        raise ValueError(f"Unsupported box format {out_fmt}")
    return torch.stack(out, dim=-1)


def box_area(boxes: Tensor) -> Tensor:
    """Area of ``(..., 4)`` xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU matrix ``(..., N, M)`` for xyxy boxes; a leading batch
    dimension is broadcast (``matcher.batched_box_iou``)."""
    boxes1, boxes2 = flush_denormals(boxes1), flush_denormals(boxes2)
    area1 = flush_denormals(box_area(boxes1))
    area2 = flush_denormals(box_area(boxes2))
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = flush_denormals(rb - lt).clamp(min=0)
    inter = flush_denormals(wh[..., 0] * wh[..., 1])
    union = flush_denormals(area1[..., :, None] + area2[..., None, :] - inter)
    return flush_denormals(torch.where(union > 0, inter / union, torch.zeros_like(inter)))
