"""PSNR (counterpart of ``metrics_tpu/functional/image/psnr.py``)."""
import math
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    psnr_vals = psnr_base_e * (10 / math.log(base))
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Tensor]:
    """The sum of squared errors and the count of its terms, over ``dim``
    (every dimension when None)."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if dim is None:
        sum_squared_error = torch.sum((preds - target) ** 2)
        # a fill, not a copy from the host: an update stays capturable; int64,
        # as the metric's count (D48)
        n_obs = torch.full((), target.numel(), dtype=torch.int64, device=target.device)
        return sum_squared_error, n_obs
    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    # an empty ``dim`` sums over no dimension (torch's empty ``dim`` would
    # sum over all of them)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list) if dim_list else diff * diff
    if not dim_list:
        n_obs = torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    else:
        count = math.prod(target.shape[d] for d in dim_list)
        n_obs = torch.full(sum_squared_error.shape, count, dtype=torch.int32, device=target.device)
    return sum_squared_error, n_obs


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR.

    Example:
        >>> import torch
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(peak_signal_noise_ratio(pred, target)), 4)
        2.5527
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    target = torch.as_tensor(target)
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    else:
        data_range = torch.tensor(float(data_range), device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
