"""PESQ wrapper (counterpart of ``metrics_tpu/functional/audio/pesq.py``).

PESQ is the ITU-T P.862 C implementation of the optional ``pesq`` package:
host work by nature. The inputs are read back to host numpy, scored clip
by clip, and the scores returned as a float32 tensor on ``device``. Gated
on the package, with the JAX package's refusal.
"""
from typing import Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import _host_float32
from metrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE

Tensor = torch.Tensor


def perceptual_evaluation_speech_quality(
    preds: Tensor, target: Tensor, fs: int, mode: str, device: Union[str, torch.device, None] = None
) -> Tensor:
    """PESQ score per clip.

    Args:
        preds: estimated signal ``[..., time]``.
        target: reference signal ``[..., time]``.
        fs: sampling frequency, 8000 or 16000 Hz.
        mode: ``'wb'`` (wide-band, 16 kHz only) or ``'nb'`` (narrow-band).
        device: where the scores are returned (CUDA unless the caller asks
            for the CPU).
    """
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that the `pesq` package is installed."
            " Install it with `pip install pesq`."
        )
    import pesq as pesq_backend

    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")

    device = resolve_device(device)
    preds_np = _host_float32(preds)
    target_np = _host_float32(target)
    _check_same_shape(preds_np, target_np)
    if preds_np.ndim == 1:
        scores = np.float32(pesq_backend.pesq(fs, target_np, preds_np, mode))
    else:
        flat_p = preds_np.reshape(-1, preds_np.shape[-1])
        flat_t = target_np.reshape(-1, target_np.shape[-1])
        scores = np.asarray(
            [pesq_backend.pesq(fs, t, p, mode) for t, p in zip(flat_t, flat_p)], dtype=np.float32
        ).reshape(preds_np.shape[:-1])
    return torch.as_tensor(np.asarray(scores, np.float32)).to(device)
