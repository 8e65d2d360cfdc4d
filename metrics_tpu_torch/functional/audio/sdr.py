"""Signal-to-distortion ratio (counterpart of ``metrics_tpu/functional/audio/sdr.py``).

The BSS-eval SDR as the JAX package computes it: the optimal distortion
filter comes from FFT auto- and cross-correlations, and the ``R h = b``
Toeplitz system is solved either densely (the default) or by a
conjugate-gradient loop whose matvec uses circulant embedding. The
distortion energy is the time-domain residual ``preds - target (*) h``, a
sum of small squares that stays accurate at high SDR. Everything runs in
the input's float dtype (float32 for float32 input).

Nothing is read back: the dense solve is ``torch.linalg.solve_ex`` (LU
with partial pivoting, JAX's algorithm) with ``check_errors=False``, so a
singular system gives inf or NaN as JAX's solve does; on the card it runs
through cuSOLVER (:func:`~metrics_tpu_torch.utilities.compute.cusolver_linalg`),
so the update can be captured (ROADMAP D65). Products and the solve run
inside :func:`~metrics_tpu_torch.utilities.compute.full_float32` (D46).
"""
import contextlib
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.compute import cusolver_linalg, full_float32

Tensor = torch.Tensor


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """FFT autocorrelation of ``target`` and its cross-correlation with
    ``preds``, truncated to ``corr_len`` lags."""
    n_fft = _next_pow2(preds.shape[-1] + target.shape[-1] - 1)
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    power = t_fft.real**2 + t_fft.imag**2
    # a complex spectrum with zero imaginary part, as JAX promotes a real
    # input of irfft
    r_0 = torch.fft.irfft(torch.complex(power, torch.zeros_like(power)), n=n_fft, dim=-1)[..., :corr_len]
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """``M[..., i, j] = vector[..., |i - j|]``, by one gather."""
    length = vector.shape[-1]
    ar = torch.arange(length, device=vector.device)
    idx = (ar[:, None] - ar[None, :]).abs()
    return vector[..., idx]


def _toeplitz_matvec(r_0: Tensor, x: Tensor, n_fft: int) -> Tensor:
    """The symmetric Toeplitz matrix of first row ``r_0`` times ``x``, by
    circulant embedding: one rfft/irfft pair."""
    length = r_0.shape[-1]
    pad = n_fft - (2 * length - 1)
    circ = torch.cat([r_0, r_0.new_zeros(r_0.shape[:-1] + (pad,)), torch.flip(r_0[..., 1:], dims=(-1,))], dim=-1)
    x_f = torch.fft.rfft(x, n=n_fft, dim=-1)
    c_f = torch.fft.rfft(circ, dim=-1)
    return torch.fft.irfft(c_f * x_f, n=n_fft, dim=-1)[..., :length]


def _toeplitz_conjugate_gradient(r_0: Tensor, b: Tensor, n_iter: int) -> Tensor:
    """Plain CG on the SPD Toeplitz system ``R x = b`` with the FFT matvec:
    ``n_iter`` steps of a Python loop (JAX's ``lax.fori_loop``)."""
    length = r_0.shape[-1]
    n_fft = _next_pow2(2 * length - 1)
    eps = torch.finfo(b.dtype).eps

    x = torch.zeros_like(b)
    r = b - _toeplitz_matvec(r_0, x, n_fft)
    p = r
    rs = torch.sum(r * r, dim=-1, keepdim=True)
    for _ in range(n_iter):
        ap = _toeplitz_matvec(r_0, p, n_fft)
        alpha = rs / (torch.sum(p * ap, dim=-1, keepdim=True) + eps)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r, dim=-1, keepdim=True)
        p = r + (rs_new / (rs + eps)) * p
        rs = rs_new
    return x


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR in dB over the last axis.

    Args:
        preds: estimated signal ``[..., time]``.
        target: reference signal ``[..., time]``.
        use_cg_iter: if given, solve the filter system with that many
            conjugate-gradient iterations instead of the dense solve.
        filter_length: length of the allowed distortion filter.
        zero_mean: subtract the per-signal mean first.
        load_diag: diagonal loading of the autocorrelation (a silent
            reference's system is singular without it).

    Example:
        >>> import torch
        >>> g = torch.Generator().manual_seed(1)
        >>> target = torch.randn(2, 800, generator=g)
        >>> preds = target + 0.1 * torch.randn(2, 800, generator=g)
        >>> signal_distortion_ratio(preds, target, filter_length=64).shape
        torch.Size([2])
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)

    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    preds = preds.to(dtype)
    target = target.to(dtype)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    # unit-norm scaling keeps the Toeplitz system well conditioned in float32
    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)

    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)

    with full_float32():
        if use_cg_iter is not None:
            sol = _toeplitz_conjugate_gradient(r_0, b, n_iter=use_cg_iter)
        else:
            with cusolver_linalg() if r_0.is_cuda else contextlib.nullcontext():
                sol = torch.linalg.solve_ex(_symmetric_toeplitz(r_0), b[..., None], check_errors=False)[0][..., 0]
        coh = torch.einsum("...l,...l->...", b, sol)

    # the distortion as the projection residual in the time domain (JAX's
    # form: ``1 - coh`` cancels in float32 above about 40 dB)
    time_len = preds.shape[-1]
    out_len = time_len + filter_length - 1
    n_full = _next_pow2(out_len)
    proj = torch.fft.irfft(
        torch.fft.rfft(target, n=n_full, dim=-1) * torch.fft.rfft(sol, n=n_full, dim=-1), n=n_full, dim=-1
    )[..., :out_len]
    preds_pad = torch.cat([preds, preds.new_zeros(preds.shape[:-1] + (out_len - time_len,))], dim=-1)
    distortion = torch.sum((preds_pad - proj) ** 2, dim=-1)

    return 10.0 * torch.log10(coh / distortion)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR in dB over the last axis.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(f"{scale_invariant_signal_distortion_ratio(preds, target):.4f}")
        18.4030
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (torch.sum(target**2, dim=-1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)
