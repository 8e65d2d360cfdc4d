"""Batched COCO greedy matching on the metric's device (counterpart of
``metrics_tpu/detection/matcher.py``).

The reference evaluates each (image, class, area-range) cell with a
sequential Python loop over score-ranked detections (pycocotools'
``COCOeval.evaluateImg``). Here, as in the JAX package, the greedy
assignment runs over every cell at once:

- detections are score-sorted on the host once per cell;
- a Python loop walks the detection axis, each step a few batched tensor
  operations over ``(cells, areas, thresholds, G)`` that carry the
  ``(T, G)`` taken-mask of every cell and area, so the sequential data
  dependence of greedy matching is kept exactly (the JAX package's
  ``lax.scan`` over the same axis, ``vmap``-ed over areas and cells);
- ragged cells ride ``(D_cap, G_cap)`` pads with validity masks.

Each step is eleven launches, so the matcher is launch-bound on the card
(ROADMAP Queue 2); no kernel of the JAX package is behind it (it is an
XLA program there, outside any Pallas kernel).

Matching semantics follow pycocotools precisely:

- a detection prefers the best still-unmatched, non-ignored ground truth
  with IoU ≥ min(t, 1-1e-10); ties go to the later gt (the reference's
  ``>=`` update rule);
- only when no non-ignored gt qualifies may it match an (unmatched) ignored
  gt, which in turn marks the detection ignored;
- matched gts (ignored or not) become unavailable at that threshold.
"""
import torch

from metrics_tpu_torch.ops.bucketed_rank import flush_denormals
from metrics_tpu_torch.utilities.compute import full_float32

Tensor = torch.Tensor

__all__ = ["match_cells", "batched_box_iou", "batched_mask_iou", "next_pow2"]

# tier bonus for non-ignored gts: must exceed any IoU bit pattern
# (bits(1.0f) = 0x3F800000) while keeping key sums < 2^31
_TIER = 0x40000000


def match_cells(ious: Tensor, det_valid: Tensor, gt_valid: Tensor, gt_ignores: Tensor, thrs: Tensor):
    """Batched matcher: ``ious (N, D, G)``, ``det_valid (N, D)``,
    ``gt_valid (N, G)``, ``gt_ignores (N, A, G)``, ``thrs (T,)`` →
    ``matches (N, A, T, D)``, ``matched_to_ignored (N, A, T, D)``.

    The two-tier preference (best non-ignored gt first, ignored gts only as
    fallback) is ONE integer argmax per step: the float32 IoUs viewed as
    int32, order-preserving for non-negative floats, plus ``_TIER`` for a
    non-ignored gt. The winner is the LAST index attaining the maximum:
    every ``(…, G)`` operand is flipped once before the loop and the
    taken-mask kept in flipped order, so ``torch.max``'s first maximum is
    JAX's last (its ``(G - 1) - argmax(key[::-1])``). The threshold
    comparison ``(N, D, T, G)`` is area-independent and taken once.
    """
    n, d_cap, g_cap = ious.shape
    a = gt_ignores.shape[1]
    t = thrs.shape[0]
    device = ious.device
    ious = flush_denormals(ious.to(torch.float32)).contiguous()
    thr_eff = torch.minimum(thrs.to(torch.float32), torch.tensor(1.0 - 1e-10, dtype=torch.float32, device=device))
    # (N, D, T, G): above the threshold and a real gt, in flipped gt order
    ok = ((ious[:, :, None, :] >= thr_eff[None, None, :, None]) & gt_valid[:, None, None, :]).flip(-1)
    tier = torch.where(gt_ignores, 0, _TIER).to(torch.int32)  # (N, A, G)
    key_all = (ious.view(torch.int32)[:, None, :, :] + tier[:, :, None, :]).flip(-1)  # (N, A, D, G)
    ignores = gt_ignores.flip(-1)
    gcol = torch.arange(g_cap, device=device)
    minus_one = torch.tensor(-1, dtype=torch.int32, device=device)
    taken = torch.zeros((n, a, t, g_cap), dtype=torch.bool, device=device)
    matches, ignored = [], []
    for d in range(d_cap):
        cand = ok[:, None, d] & ~taken  # (N, A, T, G)
        key = torch.where(cand, key_all[:, :, None, d], minus_one)
        best, m = torch.max(key, dim=-1)  # (N, A, T): the first maximum, flipped
        matched = (best >= 0) & det_valid[:, None, None, d]
        taken |= (gcol == m[..., None]) & matched[..., None]
        matches.append(matched)
        ignored.append(matched & torch.gather(ignores, 2, m))
    if not d_cap:
        empty = torch.zeros((n, a, t, 0), dtype=torch.bool, device=device)
        return empty, empty.clone()
    return torch.stack(matches, dim=-1), torch.stack(ignored, dim=-1)


def batched_box_iou(det_boxes: Tensor, gt_boxes: Tensor) -> Tensor:
    """``(N, D, 4)`` × ``(N, G, 4)`` → ``(N, D, G)`` per-cell IoU; zero-area
    pads yield IoU 0 via ``box_iou``'s union guard."""
    from metrics_tpu_torch.detection.helpers import box_iou

    return box_iou(det_boxes, gt_boxes)


def batched_mask_iou(det_masks: Tensor, gt_masks: Tensor) -> Tensor:
    """``(N, D, HW)`` × ``(N, G, HW)`` flattened binary masks →
    ``(N, D, G)`` per-cell mask IoU.

    The intersection is one batched product over the flattened pixel axis
    in full float32 (``utilities/compute.py::full_float32``: TF32 would
    round the counts), unions come from the same row sums, and zero padding
    is free: padded pixels and rows add nothing to either, and all-zero
    pads hit the ``union > 0`` guard. Counts are exact in float32 for masks
    up to 2^24 pixels, so the IoUs are bit-equal to the JAX package's.
    """
    d = det_masks.to(torch.float32)
    g = gt_masks.to(torch.float32)
    with full_float32():
        inter = torch.bmm(d, g.transpose(1, 2))
    union = d.sum(-1)[:, :, None] + g.sum(-1)[:, None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0), torch.zeros_like(inter))


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ max(n, 1): the matcher's pad caps, so a
    bucket's scan length tracks its largest cell."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()
