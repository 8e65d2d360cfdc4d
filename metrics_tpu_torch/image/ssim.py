"""``StructuralSimilarityIndexMeasure`` and its multi-scale variant
(counterpart of ``metrics_tpu/image/ssim.py``)."""
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.ssim import _multiscale_ssim_compute, _ssim_compute, _ssim_update
from metrics_tpu_torch.image._streaming import reject_valid_streaming, stream_fold, stream_init, stream_result
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


def _init_image_lists(metric: Metric) -> None:
    """The accumulate mode's states: every batch of images, in ``cat``
    lists (no fixed row shape, so no template)."""
    metric.add_state("preds", default=[], dist_reduce_fx="cat", template=None)
    metric.add_state("target", default=[], dist_reduce_fx="cat", template=None)


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM over accumulated image batches.

    Two modes: the default keeps every batch in ``cat`` lists; with
    ``streaming=True`` each update folds its per-image SSIM into two scalar
    sums (exact for ``'elementwise_mean'`` and ``'sum'``, constant memory,
    capturable on the card), which needs an explicit ``data_range``.

    Example:
        >>> import torch
        >>> imgs = torch.ones((1, 1, 16, 16)) * 0.5
        >>> metric = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> metric.update(imgs, imgs)
        >>> round(float(metric.compute()), 4)
        1.0
        >>> stream = StructuralSimilarityIndexMeasure(data_range=1.0, streaming=True, device="cpu")
        >>> stream.update(imgs, imgs)
        >>> round(float(stream.compute()), 4)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        streaming: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.streaming = bool(streaming)
        if self.streaming:
            if data_range is None:
                raise ValueError(
                    "streaming SSIM requires an explicit `data_range`: the reference infers it "
                    "from the min/max of ALL accumulated images, which a constant-memory update "
                    "cannot see"
                )
            if return_full_image or return_contrast_sensitivity:
                raise ValueError(
                    "`return_full_image`/`return_contrast_sensitivity` need per-image maps and "
                    "cannot stream; use the accumulate mode"
                )
            stream_init(self, reduction, "SSIM")
        else:
            _init_image_lists(self)
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def _per_image(self, preds: Tensor, target: Tensor) -> Tensor:
        return _ssim_compute(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, "none", self.data_range, self.k1, self.k2
        )

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        """``valid`` (bool ``(N,)``) masks images in the streaming mode only."""
        preds, target = _ssim_update(preds, target)
        if self.streaming:
            stream_fold(self, self._per_image(preds, target), preds.shape[0], valid)
            return
        reject_valid_streaming(valid)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if self.streaming:
            return stream_result(self)
        return _ssim_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.gaussian_kernel, self.sigma, self.kernel_size,
            self.reduction, self.data_range, self.k1, self.k2, self.return_full_image, self.return_contrast_sensitivity,
        )


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """MS-SSIM, with the same two modes as
    :class:`StructuralSimilarityIndexMeasure`."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = None,
        streaming: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.streaming = bool(streaming)
        if self.streaming:
            if data_range is None:
                raise ValueError(
                    "streaming MS-SSIM requires an explicit `data_range`: the reference infers "
                    "it from the min/max of ALL accumulated images"
                )
            stream_init(self, reduction, "MS-SSIM")
        else:
            _init_image_lists(self)
        if not (isinstance(kernel_size, (Sequence, int))):
            raise ValueError("Argument `kernel_size` expected to be an sequence or an int")
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def _ms_ssim(self, preds: Tensor, target: Tensor, reduction: Optional[str]) -> Tensor:
        return _multiscale_ssim_compute(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, reduction, self.data_range,
            self.k1, self.k2, self.betas, self.normalize,
        )

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        """``valid`` (bool ``(N,)``) masks images in the streaming mode only."""
        preds, target = _ssim_update(preds, target)
        if self.streaming:
            stream_fold(self, self._ms_ssim(preds, target, "none"), preds.shape[0], valid)
            return
        reject_valid_streaming(valid)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        if self.streaming:
            return stream_result(self)
        return self._ms_ssim(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)
