"""Top-label calibration error (counterpart of
``metrics_tpu/functional/classification/calibration_error.py``).

Binning sums a batch into ``n_bins`` count, confidence and accuracy sums
with ``index_add_`` (the JAX package's ``segment_sum``). The bin edges come
from :func:`~metrics_tpu_torch.utilities.data.jax_linspace`, bit for bit
``jnp.linspace``, and both the edges and the confidences are flushed of
float32 denormals before ``searchsorted``, as XLA compares them. On the card
``index_add_`` of floats adds with atomics, so the confidence and accuracy
sums may differ in their last bits from run to run; the counts are exact.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.bucketed_rank import flush_denormals
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.data import jax_linspace
from metrics_tpu_torch.utilities.enums import DataType

Tensor = torch.Tensor

_NORMS = ("l1", "l2", "max")


def _ce_bin_update(
    confidences: Tensor,
    accuracies: Tensor,
    n_bins: int,
    valid: Optional[Tensor] = None,
    boundaries: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """A batch's ``(n_bins,)`` float32 count, confidence-sum and
    accuracy-sum; a row that the bool ``(N,)`` ``valid`` mask leaves out
    adds nothing. Both the list mode and the binned state bin through here."""
    if boundaries is None:
        boundaries = jax_linspace(0.0, 1.0, n_bins + 1, device=confidences.device)
    pos = torch.searchsorted(flush_denormals(boundaries), flush_denormals(confidences), right=False)
    indices = torch.clamp(pos - 1, 0, n_bins - 1)
    weight = torch.ones_like(confidences) if valid is None else torch.as_tensor(valid, device=confidences.device).to(confidences.dtype)

    def segment_sum(values: Tensor) -> Tensor:
        return torch.zeros(n_bins, dtype=values.dtype, device=values.device).index_add_(0, indices, values)

    return segment_sum(weight), segment_sum(confidences * weight), segment_sum(accuracies * weight)


def _ce_compute_from_bins(
    count_bin: Tensor, conf_sum_bin: Tensor, acc_sum_bin: Tensor, norm: str = "l1", debias: bool = False
) -> Tensor:
    """The calibration error from per-bin sums."""
    if norm not in _NORMS:
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    empty = count_bin == 0
    safe = torch.where(empty, 1.0, count_bin)
    conf_bin = torch.where(empty, 0.0, conf_sum_bin / safe)
    acc_bin = torch.where(empty, 0.0, acc_sum_bin / safe)
    prop_bin = count_bin / count_bin.sum()
    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(acc_bin - conf_bin))
    ce = torch.sum((acc_bin - conf_bin) ** 2 * prop_bin)
    if debias:
        n_total = count_bin.sum()
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * n_total - 1)
        ce = ce + torch.sum(torch.nan_to_num(debias_bins))
    return torch.where(ce > 0, torch.sqrt(torch.clamp(ce, min=0)), 0.0)


def _ce_compute(
    confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor, norm: str = "l1", debias: bool = False
) -> Tensor:
    """Bin the rows, then :func:`_ce_compute_from_bins`."""
    n_bins = bin_boundaries.shape[0] - 1
    count, conf_sum, acc_sum = _ce_bin_update(confidences, accuracies, n_bins, boundaries=bin_boundaries)
    return _ce_compute_from_bins(count, conf_sum, acc_sum, norm=norm, debias=debias)


def _softmax(x: Tensor) -> Tensor:
    """``jax.nn.softmax`` over dim 1, in its order of operations."""
    e = torch.exp(x - torch.amax(x, dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def _ce_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """float32 top-1 confidences and correctness. Scores outside [0, 1]
    go through a sigmoid (binary) or a softmax (multi-class); the test is a
    tensor op, so nothing is read back."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _, _, mode = _input_format_classification(preds, target)

    if mode in (DataType.BINARY, DataType.MULTICLASS):
        flat = flush_denormals(preds)
        in01 = torch.all((flat >= 0) & (flat <= 1))
    if mode == DataType.BINARY:
        preds = torch.where(in01, preds, torch.sigmoid(preds))
        confidences, accuracies = preds, target
    elif mode == DataType.MULTICLASS:
        preds = torch.where(in01, preds, _softmax(preds))
        flat = flush_denormals(preds)
        confidences = torch.amax(flat, dim=1)
        accuracies = torch.argmax(flat, dim=1) == target
    elif mode == DataType.MULTIDIM_MULTICLASS:
        flat = flush_denormals(torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1]))
        confidences = torch.amax(flat, dim=1)
        accuracies = torch.argmax(flat, dim=1) == target.reshape(-1)
    else:
        raise ValueError(
            f"Calibration error is not well-defined for data with size {tuple(preds.shape)} and targets {tuple(target.shape)}."
        )
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(preds: Tensor, target: Tensor, n_bins: int = 15, norm: str = "l1") -> Tensor:
    """Top-label calibration error.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> print(f"{calibration_error(preds, target, n_bins=2, norm='l1'):.3f}")
        0.290
    """
    if norm not in _NORMS:
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")

    confidences, accuracies = _ce_update(preds, target)
    bin_boundaries = jax_linspace(0.0, 1.0, n_bins + 1, device=confidences.device)
    return _ce_compute(confidences, accuracies, bin_boundaries, norm=norm)
