"""STOI wrapper (counterpart of ``metrics_tpu/functional/audio/stoi.py``).

The same host boundary as PESQ: the optional ``pystoi`` package scores each
clip on host numpy, and the scores come back as a float32 tensor on
``device``. ``use_device_implementation=True`` scores with the port's own
STOI (``stoi_native.stoi_on_device``) instead, without ``pystoi``.
"""
from typing import Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import _host_float32
from metrics_tpu_torch.utilities.imports import _PYSTOI_AVAILABLE

Tensor = torch.Tensor


def short_time_objective_intelligibility(
    preds: Tensor,
    target: Tensor,
    fs: int,
    extended: bool = False,
    use_device_implementation: bool = False,
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """STOI score per clip.

    Args:
        preds: estimated signal ``[..., time]``.
        target: reference signal ``[..., time]``.
        fs: sampling frequency in Hz.
        extended: the extended STOI variant.
        use_device_implementation: score with the native implementation
            (``stoi_native.stoi_on_device``), no ``pystoi`` needed. The
            default keeps the JAX package's pystoi wrapper.
        device: where the scores are returned, and where the native core
            runs (CUDA unless the caller asks for the CPU).
    """
    if use_device_implementation:
        from metrics_tpu_torch.functional.audio.stoi_native import stoi_on_device

        _check_same_shape(torch.as_tensor(preds), torch.as_tensor(target))
        return stoi_on_device(preds, target, fs=fs, extended=extended, device=device)
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(
            "STOI metric requires that the `pystoi` package is installed."
            " Install it with `pip install pystoi`, or pass"
            " `use_device_implementation=True` for the native JAX implementation."
        )
    from pystoi import stoi as stoi_backend

    device = resolve_device(device)
    preds_np = _host_float32(preds)
    target_np = _host_float32(target)
    _check_same_shape(preds_np, target_np)
    if preds_np.ndim == 1:
        scores = np.float32(stoi_backend(target_np, preds_np, fs, extended))
    else:
        flat_p = preds_np.reshape(-1, preds_np.shape[-1])
        flat_t = target_np.reshape(-1, target_np.shape[-1])
        scores = np.asarray(
            [stoi_backend(t, p, fs, extended) for t, p in zip(flat_t, flat_p)], dtype=np.float32
        ).reshape(preds_np.shape[:-1])
    return torch.as_tensor(np.asarray(scores, np.float32)).to(device)
