"""SSIM and multi-scale SSIM (counterpart of
``metrics_tpu/functional/image/ssim.py``).

The five filtered moments (mu_p, mu_t, E[p^2], E[t^2], E[pt]) come from one
separable depthwise filter over a 5B-stacked batch (``helper.py``), after a
reflect pad; the padded border is left out of the score.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from metrics_tpu_torch.functional.image.helper import _depthwise_conv_separable, _reflect_pad, _separable_factors
from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _ssim_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _crop(pads: Sequence[int]) -> tuple:
    return tuple(slice(p, -p) if p else slice(None) for p in pads)


def _ssim_compute(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    is_3d = preds.ndim == 5
    spatial = 3 if is_3d else 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = spatial * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = spatial * [sigma]
    if len(kernel_size) != spatial or len(sigma) != spatial:
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less than target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    preds = preds.to(dtype)
    target = target.to(dtype)
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    if gaussian_kernel:
        pads = [(gs - 1) // 2 for gs in gauss_kernel_size]
        factors = _separable_factors(gauss_kernel_size, sigma, True, dtype, preds.device)
    else:
        pads = [(ks - 1) // 2 for ks in kernel_size]
        factors = _separable_factors(kernel_size, sigma, False, dtype, preds.device)

    preds_p = _reflect_pad(preds, pads)
    target_p = _reflect_pad(target, pads)
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

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2
    ssim_idx_full_image = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)
    # only interior pixels, whose window never touched the padding, enter
    # the score; the full map is what ``return_full_image`` gives
    ssim_idx = ssim_idx_full_image[(Ellipsis, *_crop(pads))]

    if return_contrast_sensitivity:
        # cropped over the last two dims with the first two pads, for 3-d
        # input too, as the JAX package (and its reference) does
        contrast_sensitivity = (upper / lower)[(Ellipsis, *_crop(pads[:2]))]
        return (
            reduce(ssim_idx.reshape(b, -1).mean(-1), reduction),
            reduce(contrast_sensitivity.reshape(b, -1).mean(-1), reduction),
        )
    if return_full_image:
        return reduce(ssim_idx.reshape(b, -1).mean(-1), reduction), reduce(ssim_idx_full_image, reduction)
    return reduce(ssim_idx.reshape(b, -1).mean(-1), reduction)


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """SSIM.

    Example:
        >>> import torch
        >>> preds = torch.rand((8, 3, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> float(structural_similarity_index_measure(preds, target)) > 0.9
        True
    """
    preds, target = _ssim_update(preds, target)
    return _ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )


def _get_normalized_sim_and_cs(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    normalize: Optional[str] = None,
) -> Tuple[Tensor, Tensor]:
    sim, contrast_sensitivity = _ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2,
        return_contrast_sensitivity=True,
    )
    if normalize == "relu":
        sim = torch.relu(sim)
        contrast_sensitivity = torch.relu(contrast_sensitivity)
    return sim, contrast_sensitivity


def _avg_pool(x: Tensor) -> Tensor:
    return F.avg_pool2d(x, 2) if x.ndim == 4 else F.avg_pool3d(x, 2)


def _multiscale_ssim_compute(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    spatial = 3 if preds.ndim == 5 else 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = spatial * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = spatial * [sigma]
    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    # each scale is reduced with the caller's reduction before the
    # beta-weighted product, as in the JAX package
    sim_list: List[Tensor] = []
    cs_list: List[Tensor] = []
    for _ in range(len(betas)):
        sim, contrast_sensitivity = _get_normalized_sim_and_cs(
            preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2, normalize=normalize
        )
        sim_list.append(sim)
        cs_list.append(contrast_sensitivity)
        preds = _avg_pool(preds)
        target = _avg_pool(target)

    if normalize == "simple":
        sim_list = [(s + 1) / 2 for s in sim_list]
        cs_list = [(c + 1) / 2 for c in cs_list]
    # each scale to its own power (Python floats: no copy from the host, so
    # a streaming update stays capturable); per sample when not reduced
    weighted = [c**beta for c, beta in zip(cs_list[:-1], betas[:-1])] + [sim_list[-1] ** betas[-1]]
    return torch.prod(torch.stack(weighted), dim=0)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """MS-SSIM.

    Example:
        >>> import torch
        >>> preds = torch.rand((2, 1, 192, 192), generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> float(multiscale_structural_similarity_index_measure(preds, target, data_range=1.0)) > 0.9
        True
    """
    if not isinstance(betas, tuple) or not all(isinstance(b, float) for b in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_update(preds, target)
    return _multiscale_ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2, betas, normalize
    )
