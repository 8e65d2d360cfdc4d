"""FID and KID math (counterpart of ``metrics_tpu/functional/image/fid.py``).

The square root of ``sigma1 @ sigma2`` is a Newton-Schulz iteration (matrix
products only, differentiable), inside a ladder: (1) Newton-Schulz on the
raw product, (2) on diagonally loaded covariances, (3) an exact terminal,
the nuclear norm of the centered cross matrix when the caller has the
centered features and it stays small, the ``eigh`` trace otherwise. A rung
is taken when its residual ``||S @ S - A|| / ||A||`` is finite and under
1e-2. JAX picks the rung with ``lax.cond``; the port's compute is eager
(D38), so it picks the rung in Python after one read back of each
residual check: the same rungs in the same order, with the same bound and
the same ``16 * d * d`` choice of terminal. Every product runs in full
float32 (no TF32 on the card), as JAX's ``Precision.HIGHEST``.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.compute import full_float32

Tensor = torch.Tensor

#: the ladder's rungs, in order
RUNGS = ("newton_schulz", "newton_schulz_loaded", "nuclear_norm", "eigh")

# a rung is taken when its residual is finite and under this
_RESIDUAL_BOUND = 1e-2


def _newton_schulz_sqrtm(mat: Tensor, num_iters: int = 50, eps: float = 1e-12) -> Tensor:
    """Matrix square root of a PSD matrix by Newton-Schulz iteration. A
    diverging iteration is clamped to finite values (the residual check
    rejects it), so no NaN reaches a gradient."""
    dim = mat.shape[0]
    norm = torch.sqrt(torch.sum(mat * mat)) + eps
    y = mat / norm
    ident = torch.eye(dim, dtype=mat.dtype, device=mat.device)
    z = ident
    clamp = 1e6
    for _ in range(num_iters):
        t = 0.5 * (3.0 * ident - z @ y)
        y, z = torch.clamp(y @ t, -clamp, clamp), torch.clamp(t @ z, -clamp, clamp)
    return y * torch.sqrt(norm)


def _trace_sqrtm_psd_product(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """Exact ``trace(sqrtm(sigma1 @ sigma2))`` for PSD factors by ``eigh``."""
    w1, v1 = torch.linalg.eigh(sigma1)
    s1h = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))) @ v1.T
    inner = s1h @ sigma2 @ s1h
    ev = torch.linalg.eigvalsh((inner + inner.T) / 2)
    return torch.sqrt(torch.clamp(ev, min=0.0)).sum()


def _trace_sqrtm_from_centered(xc: Tensor, yc: Tensor) -> Tensor:
    """``trace(sqrtm(sigma1 @ sigma2)) = ||xc @ yc.T||_* / sqrt((n-1)(m-1))``:
    exact at every rank, with finite gradients at rank deficiency."""
    n, m = xc.shape[0], yc.shape[0]
    sv = torch.linalg.svdvals(xc @ yc.T)
    return sv.sum() / torch.sqrt(torch.tensor((n - 1) * (m - 1), dtype=sv.dtype, device=sv.device))


def _mean_cov(features: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Mean, unbiased covariance and the centered features."""
    n = features.shape[0]
    mu = features.mean(dim=0)
    centered = features - mu
    with full_float32(features.is_cuda):
        sigma = centered.T @ centered / (n - 1)
    return mu, sigma, centered


def _mean_cov_masked(features: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The masked form of :func:`_mean_cov` over a ring: invalid rows weigh
    nothing. Also returns the count of valid rows (a tensor)."""
    w = mask.to(features.dtype)[:, None]
    n = w.sum()
    mu = (features * w).sum(dim=0) / n
    centered = (features - mu) * w
    with full_float32(features.is_cuda):
        sigma = centered.T @ centered / (n - 1)
    return mu, sigma, n


def _residual_ok(sq: Tensor, prod: Tensor) -> bool:
    """The rung's check, on detached values, with one read back."""
    sq, prod = sq.detach(), prod.detach()
    residual = torch.sqrt(torch.sum((sq @ sq - prod) ** 2)) / (torch.sqrt(torch.sum(prod * prod)) + 1e-30)
    return bool(torch.isfinite(residual) & (residual < _RESIDUAL_BOUND))


def _trace_sqrtm_ladder(
    sigma1: Tensor, sigma2: Tensor, eps: float = 1e-6, centered: Optional[Tuple[Tensor, Tensor]] = None
) -> Tuple[Tensor, str]:
    """``trace(sqrtm(sigma1 @ sigma2))`` and the name of the rung that gave it."""
    prod = sigma1 @ sigma2
    sq = _newton_schulz_sqrtm(prod)
    if _residual_ok(sq, prod):
        return torch.trace(sq), RUNGS[0]
    offset = torch.eye(sigma1.shape[0], dtype=sigma1.dtype, device=sigma1.device) * eps
    loaded = (sigma1 + offset) @ (sigma2 + offset)
    sq = _newton_schulz_sqrtm(loaded)
    if _residual_ok(sq, loaded):
        return torch.trace(sq), RUNGS[1]
    if centered is not None:
        xc, yc = centered
        d = sigma1.shape[0]
        # the (n, m) cross matrix stays SVD-sized only up to 16x the eigh
        # terminal's d^2
        if xc.shape[0] * yc.shape[0] <= 16 * d * d:
            return _trace_sqrtm_from_centered(xc, yc), RUNGS[2]
    return _trace_sqrtm_psd_product(sigma1, sigma2), RUNGS[3]


def _compute_fid_with_rung(
    mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor, eps: float = 1e-6,
    centered: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tensor, str]:
    """The Frechet distance between two Gaussians, and the ladder's rung."""
    with full_float32(sigma1.is_cuda):
        tr_covmean, rung = _trace_sqrtm_ladder(sigma1, sigma2, eps, centered)
    diff = mu1 - mu2
    return torch.sum(diff * diff) + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean, rung


def _compute_fid(
    mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor, eps: float = 1e-6,
    centered: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """The Frechet distance between two Gaussians."""
    return _compute_fid_with_rung(mu1, sigma1, mu2, sigma2, eps, centered)[0]


def frechet_inception_distance_from_features(real_features: Tensor, fake_features: Tensor) -> Tensor:
    """FID from feature matrices ``(N, D)``, in float64 when the real
    features are float64 (JAX: when x64 is on), float32 otherwise."""
    real_features = torch.as_tensor(real_features)
    dtype = torch.float64 if real_features.dtype == torch.float64 else torch.float32
    real_features = real_features.to(dtype)
    fake_features = torch.as_tensor(fake_features, device=real_features.device).to(dtype)
    mu1, sigma1, xc = _mean_cov(real_features)
    mu2, sigma2, yc = _mean_cov(fake_features)
    return _compute_fid(mu1, sigma1, mu2, sigma2, centered=(xc, yc))


def _poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """Polynomial kernel ``(f1 @ f2.T * gamma + coef) ** degree``."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    with full_float32(f1.is_cuda):
        return (f1 @ f2.T * gamma + coef) ** degree


def _poly_mmd(f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """Unbiased polynomial-kernel MMD^2."""
    k_11 = _poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = _poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = _poly_kernel(f_real, f_fake, degree, gamma, coef)
    m = f_real.shape[0]
    kt_xx_sums = k_11.sum(dim=-1) - torch.diagonal(k_11)
    kt_yy_sums = k_22.sum(dim=-1) - torch.diagonal(k_22)
    k_xy_sums = k_12.sum(dim=0)
    value = (kt_xx_sums.sum() + kt_yy_sums.sum()) / (m * (m - 1))
    return value - 2 * k_xy_sums.sum() / (m**2)
