"""Universal Image Quality Index (counterpart of
``metrics_tpu/functional/image/uqi.py``): one separable depthwise filter
over the 5B stack, as SSIM's."""
from typing import Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.image.helper import _depthwise_conv_separable, _reflect_pad, _separable_factors
from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _uqi_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    preds = preds.to(dtype)
    target = target.to(dtype)
    factors = _separable_factors(kernel_size, sigma, True, dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds_p = _reflect_pad(preds, (pad_h, pad_w))
    target_p = _reflect_pad(target, (pad_h, pad_w))
    input_list = torch.cat((preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p))
    outputs = _depthwise_conv_separable(input_list, factors)
    b = preds.shape[0]
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = (outputs[i * b : (i + 1) * b] for i in range(5))

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower)
    uqi_idx = uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]
    return reduce(uqi_idx, reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    """UQI.

    Example:
        >>> import torch
        >>> preds = torch.rand((8, 3, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> float(universal_image_quality_index(preds, target)) > 0.9
        True
    """
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction, data_range)
