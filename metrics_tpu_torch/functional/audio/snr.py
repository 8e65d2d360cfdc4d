"""Signal-to-noise ratio (counterpart of ``metrics_tpu/functional/audio/snr.py``).

Elementwise work and reductions over the trailing time axis; nothing is
read back.
"""
import torch

from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
from metrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR in dB over the last axis.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(f"{signal_noise_ratio(preds, target):.4f}")
        16.1805
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR: SI-SDR of zero-mean inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(f"{scale_invariant_signal_noise_ratio(preds, target):.4f}")
        15.0918
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)
