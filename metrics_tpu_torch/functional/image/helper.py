"""Image window helpers (counterpart of ``metrics_tpu/functional/image/helper.py``).

The Gaussian and box windows of SSIM and UQI are outer products of 1-d
factors, so the depthwise filter runs as one 1-d pass per spatial
dimension. JAX writes each pass as a banded-matrix product, the TPU's
matrix unit being its fast path; on the card each pass is a depthwise
convolution with a ``(k, 1)`` or ``(1, k)`` kernel, which ran SSIM at
2x3x512x512 faster than the banded product on an H100 (PERF.md §6,
``chip_smoke.py``'s ``image_functional_path`` times both). The sums run
in another order than XLA's: SSIM and UQI agree with JAX within
``atol=1e-5`` (ROADMAP W6, D45). Every pass runs in full float32 on the
card (no TF32), as JAX's ``Precision.HIGHEST``.
"""
from typing import Sequence

import torch
import torch.nn.functional as F

from metrics_tpu_torch.utilities.compute import full_float32

Tensor = torch.Tensor


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device=None) -> Tensor:
    """1-d Gaussian window, ``(1, kernel_size)``."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-((dist / sigma) ** 2) / 2)
    return (gauss / gauss.sum())[None, :]


def _separable_factors(
    kernel_size: Sequence[int], sigma: Sequence[float], gaussian: bool, dtype: torch.dtype, device=None
) -> Sequence[Tensor]:
    """The 1-d factor of each spatial dimension: Gaussian, or a uniform box."""
    if gaussian:
        return [_gaussian(k, s, dtype, device)[0] for k, s in zip(kernel_size, sigma)]
    return [torch.ones((k,), dtype=dtype, device=device) / k for k in kernel_size]


def _depthwise_conv_separable(x: Tensor, factors: Sequence[Tensor]) -> Tensor:
    """Valid-mode depthwise filtering in full float32: each pass a
    convolution with a 1-d kernel along its axis (``groups`` = channels)."""
    channel = x.shape[1]
    spatial = x.ndim - 2
    conv = F.conv2d if spatial == 2 else F.conv3d
    out = x
    with full_float32(x.is_cuda):
        for dim, f in enumerate(factors):
            kshape = [1] * spatial
            kshape[dim] = f.shape[-1]
            kernel = f.reshape(kshape).expand(channel, 1, *kshape).contiguous()
            out = conv(out, kernel, groups=channel)
    return out


def _reflect_pad(x: Tensor, pads: Sequence[int]) -> Tensor:
    """Reflect-pad the trailing spatial dims of an NC... tensor."""
    pad = []
    for p in reversed(list(pads)):
        pad += [p, p]
    return F.pad(x, pad, mode="reflect")
