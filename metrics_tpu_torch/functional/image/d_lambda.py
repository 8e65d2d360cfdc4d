"""Spectral Distortion Index (counterpart of
``metrics_tpu/functional/image/d_lambda.py``): the UQI of every pair of
bands in one batched evaluation, the C*C pairs stacked into the batch
axis."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.image.uqi import _uqi_compute
from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _spectral_distortion_index_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            f"Expected `ms` and `fused` to have the same data type. Got ms: {preds.dtype} and fused: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _band_pair_uqi_matrix(x: Tensor) -> Tensor:
    """(C, C) UQI between every pair of bands of ``x``, averaged over the
    batch."""
    b, c, h, w = x.shape
    pairs_k = x[:, :, None].expand(b, c, c, h, w).reshape(b * c * c, 1, h, w)
    pairs_r = x[:, None, :].expand(b, c, c, h, w).reshape(b * c * c, 1, h, w)
    vals = _uqi_compute(pairs_k, pairs_r, reduction="none")
    return vals.reshape(b, c, c, -1).mean(dim=(0, 3))


def _spectral_distortion_index_compute(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    length = preds.shape[1]
    m1 = _band_pair_uqi_matrix(target)
    m2 = _band_pair_uqi_matrix(preds)
    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (1.0 / (length * (length - 1)) * torch.sum(diff)) ** (1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """D-lambda.

    Example:
        >>> import torch
        >>> preds = torch.rand((2, 3, 16, 16), generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.9
        >>> float(spectral_distortion_index(preds, target)) < 0.1
        True
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_update(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
