"""``PeakSignalNoiseRatio`` (counterpart of ``metrics_tpu/image/psnr.py``)."""
from typing import Any, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


class PeakSignalNoiseRatio(Metric):
    """PSNR. Without ``dim`` it keeps the sum of squared errors, the count
    of pixels and, without ``data_range``, the targets' min and max; with
    ``dim`` it keeps one row of each per update. The count is int64: JAX's
    int32 count wraps past 2^31 pixels, 10,923 RGB images at 256x256
    (stated difference D48).

    Example:
        >>> import torch
        >>> imgs = torch.ones((1, 1, 16, 16)) * 0.5
        >>> metric = PeakSignalNoiseRatio(data_range=1.0, device="cpu")
        >>> metric.update(imgs, imgs * 0.9)
        >>> round(float(metric.compute()), 4)
        26.0206
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        if dim is None:
            self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0, dtype=torch.int64), dist_reduce_fx="sum")
        else:
            # each row keeps the dimensions `dim` does not reduce: no fixed
            # row shape, so no template
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(float("-inf")), dist_reduce_fx="max")
        else:
            self.data_range = torch.tensor(float(data_range), device=self.device)
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, (list, tuple)) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min().to(self.min_target.dtype), self.min_target)
                self.max_target = torch.maximum(target.max().to(self.max_target.dtype), self.max_target)
            self.sum_squared_error += sum_squared_error
            self.total += n_obs.to(self.total.dtype)
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat(self.sum_squared_error)
            total = dim_zero_cat(self.total)
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
