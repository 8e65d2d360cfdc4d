"""The ``(value_sum, n_elements)`` states of the image metrics'
``streaming=True`` mode (counterpart of ``metrics_tpu/image/_streaming.py``).

SSIM, MS-SSIM, UQI, ERGAS and SAM are per-image independent and reduce by a
plain mean or sum over their unreduced output, so folding that output into
two scalar sums at update is exact for ``reduction='elementwise_mean'|'sum'``
and keeps constant memory where the accumulate mode keeps every image.
(D-lambda has no such mode: its cross-band norm is nonlinear in the batch's
statistics.)
"""
from typing import Any, Optional

import torch

Tensor = torch.Tensor

__all__ = ["stream_init", "stream_fold", "stream_result", "reject_valid_streaming"]


def stream_init(metric: Any, reduction: Optional[str], owner: str) -> None:
    """Check the reduction and register the two float32 sum states."""
    if reduction not in ("elementwise_mean", "sum"):
        raise ValueError(
            f"streaming {owner} requires reduction 'elementwise_mean' or 'sum'; use the "
            "accumulate mode for 'none'"
        )
    metric.add_state("value_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
    metric.add_state("n_elements", default=torch.tensor(0.0), dist_reduce_fx="sum")


def stream_fold(metric: Any, vals: Tensor, n_images: int, valid: Optional[Tensor]) -> None:
    """Fold an unreduced output into the sums; ``valid`` masks whole images
    (rows of the leading axis) by select, so a NaN of a masked row never
    reaches the sums."""
    if valid is None:
        metric.value_sum += vals.sum()
        metric.n_elements += float(vals.numel())
    else:
        keep = torch.as_tensor(valid, device=vals.device).to(torch.bool)
        rows = vals.reshape(n_images, -1)
        metric.value_sum += torch.where(keep[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)).sum()
        metric.n_elements += keep.to(torch.float32).sum() * (vals.numel() // n_images)


def stream_result(metric: Any) -> Tensor:
    return metric.value_sum if metric.reduction == "sum" else metric.value_sum / metric.n_elements


def reject_valid_streaming(valid: Optional[Tensor]) -> None:
    """The accumulate mode's guard: ``valid`` masks exist in the streaming
    mode only."""
    if valid is not None:
        raise ValueError("`valid` masks are only supported in streaming mode")
