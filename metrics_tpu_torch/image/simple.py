"""UQI, ERGAS, SAM and D-lambda (counterpart of ``metrics_tpu/image/simple.py``).

UQI, ERGAS and SAM have the ``streaming=True`` mode of ``_streaming.py``
(exact for ``'elementwise_mean'`` and ``'sum'``); the default mode keeps
every batch of images. D-lambda has no streaming mode (see its class).
"""
from typing import Any, Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.image.d_lambda import (
    _spectral_distortion_index_compute,
    _spectral_distortion_index_update,
)
from metrics_tpu_torch.functional.image.ergas import _ergas_compute, _ergas_update
from metrics_tpu_torch.functional.image.sam import _sam_compute, _sam_update
from metrics_tpu_torch.functional.image.uqi import _uqi_compute, _uqi_update
from metrics_tpu_torch.image._streaming import reject_valid_streaming, stream_fold, stream_init, stream_result
from metrics_tpu_torch.image.ssim import _init_image_lists
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class _StreamableImageMetric(Metric):
    """The shared update and compute of UQI, ERGAS and SAM: ``_value(preds,
    target, reduction)`` is the metric's kernel, ``_check`` its input
    check."""

    is_differentiable = True
    full_state_update = False

    def _init_modes(self, reduction: Optional[str], streaming: bool, owner: str) -> None:
        self.reduction = reduction
        self.streaming = bool(streaming)
        if self.streaming:
            stream_init(self, reduction, owner)
        else:
            _init_image_lists(self)

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        """``valid`` (bool ``(N,)``) masks images in the streaming mode only."""
        preds, target = self._check(preds, target)
        if self.streaming:
            stream_fold(self, self._value(preds, target, "none"), preds.shape[0], valid)
            return
        reject_valid_streaming(valid)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        if self.streaming:
            return stream_result(self)
        return self._value(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)


class UniversalImageQualityIndex(_StreamableImageMetric):
    """UQI.

    Example:
        >>> import torch
        >>> imgs = torch.linspace(0, 1, 3 * 16 * 16).reshape(1, 3, 16, 16)
        >>> metric = UniversalImageQualityIndex(device="cpu")
        >>> metric.update(imgs, imgs)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = True

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        streaming: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if streaming and data_range is None:
            raise ValueError(
                "streaming UQI requires an explicit `data_range` (the reference infers it "
                "from the min/max of ALL accumulated images)"
            )
        self._init_modes(reduction, streaming, "UQI")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range

    _check = staticmethod(_uqi_update)

    def _value(self, preds: Tensor, target: Tensor, reduction: Optional[str]) -> Tensor:
        return _uqi_compute(preds, target, self.kernel_size, self.sigma, reduction, self.data_range)


class ErrorRelativeGlobalDimensionlessSynthesis(_StreamableImageMetric):
    """ERGAS."""

    higher_is_better = False

    def __init__(
        self,
        ratio: Union[int, float] = 4,
        reduction: Optional[str] = "elementwise_mean",
        streaming: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._init_modes(reduction, streaming, "ERGAS")
        self.ratio = ratio

    _check = staticmethod(_ergas_update)

    def _value(self, preds: Tensor, target: Tensor, reduction: Optional[str]) -> Tensor:
        return _ergas_compute(preds, target, self.ratio, reduction)


class SpectralAngleMapper(_StreamableImageMetric):
    """SAM.

    Example:
        >>> import torch
        >>> imgs = torch.ones((1, 3, 16, 16)) * 0.5
        >>> metric = SpectralAngleMapper(device="cpu")
        >>> metric.update(imgs, imgs)
        >>> round(float(metric.compute()), 4)
        0.0
    """

    higher_is_better = False

    def __init__(self, reduction: Optional[str] = "elementwise_mean", streaming: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._init_modes(reduction, streaming, "SAM")

    _check = staticmethod(_sam_update)

    def _value(self, preds: Tensor, target: Tensor, reduction: Optional[str]) -> Tensor:
        return _sam_compute(preds, target, reduction)


class SpectralDistortionIndex(Metric):
    """D-lambda. ``higher_is_better`` is False: it is a distortion index
    (the JAX package flags it so too).

    No streaming mode: the cross-band UQI matrix is taken over the whole
    accumulated batch and the ``|Q1 - Q2|^p`` norm is nonlinear in those
    batch statistics, so a per-batch fold would not be the metric.
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, p: int = 1, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        allowed_reductions = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reductions:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reductions} but got {reduction}")
        self.reduction = reduction
        _init_image_lists(self)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _spectral_distortion_index_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _spectral_distortion_index_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.p, self.reduction
        )
