"""Input checks and reductions of the pairwise functions (counterpart of
``metrics_tpu/functional/pairwise/helpers.py``)."""
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _check_input(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tuple[Tensor, Tensor, bool]:
    """``x`` of shape ``(N, d)``, ``y`` of shape ``(M, d)`` (``x`` itself
    when not given), and whether to zero the diagonal: by default only when
    ``y`` is not given."""
    x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")

    if y is not None:
        y = torch.as_tensor(y, device=x.device)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _zero_diagonal(distance: Tensor) -> Tensor:
    """``distance * (1 - I)``, as the JAX package writes it (so an infinite
    diagonal entry becomes NaN there too)."""
    eye = torch.eye(distance.shape[0], distance.shape[1], dtype=distance.dtype, device=distance.device)
    return distance * (1 - eye)


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction in (None, "none"):
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")
