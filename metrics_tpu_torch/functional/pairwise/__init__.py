"""Pairwise distances and similarities between the rows of two matrices
(counterpart of ``metrics_tpu/functional/pairwise/__init__.py``).

Cosine, euclidean and linear are one matrix product each
(``_safe_matmul``), run in float32: ``torch.backends.cuda.matmul.allow_tf32``
must stay False (PyTorch's default) for the card's products to keep
float32's precision. The manhattan distance is ``torch.cdist(x, y, p=1)``:
the JAX package's broadcast-subtract-sum is fused by XLA, while eager torch
would build the ``(N, M, d)`` difference (51 GB at 4096 x 4096 x 768
float32); ``cdist`` sums each pair's ``d`` absolute differences in its own
order, so its float32 sums differ from the JAX package's in the last bits.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utilities.compute import _safe_matmul

Tensor = torch.Tensor


def pairwise_cosine_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Cosine similarity of every row of ``x`` with every row of ``y``.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_cosine_similarity(x, y).round(decimals=4)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437],
                [0.5300, 0.8533]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    norm_x = x / torch.linalg.norm(x, ord=2, dim=1, keepdim=True)
    norm_y = y / torch.linalg.norm(y, ord=2, dim=1, keepdim=True)
    distance = _safe_matmul(norm_x, norm_y.T)
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return _reduce_distance_matrix(distance, reduction)


def pairwise_euclidean_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Euclidean distance of every row of ``x`` to every row of ``y``, as
    ``sqrt(|x|^2 + |y|^2 - 2 x.y)`` clamped at 0.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_euclidean_distance(x, y).round(decimals=4)
        tensor([[3.1623, 2.0000],
                [5.3852, 4.1231],
                [8.9443, 7.6158]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm = (x * x).sum(dim=1, keepdim=True)
    y_norm = (y * y).sum(dim=1)
    distance = x_norm + y_norm - 2 * _safe_matmul(x, y.T)
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return _reduce_distance_matrix(torch.sqrt(torch.clamp(distance, min=0)), reduction)


def pairwise_linear_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """``x @ y.T``.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_linear_similarity(x, y)
        tensor([[ 2.,  7.],
                [ 3., 11.],
                [ 5., 18.]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distance = _safe_matmul(x, y.T)
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return _reduce_distance_matrix(distance, reduction)


def pairwise_manhattan_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Sum of absolute differences of every row of ``x`` and every row of
    ``y``, without building their ``(N, M, d)`` difference (integer inputs,
    which ``cdist`` refuses, take the broadcast).

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1., 0], [2, 1]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[ 4.,  2.],
                [ 7.,  5.],
                [12., 10.]])
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    if x.is_floating_point():
        distance = torch.cdist(x, y.to(x.dtype), p=1.0)
    else:
        diff = torch.abs(x[:, None] - y[None, :])
        distance = diff.sum(dim=-1, dtype=diff.dtype)  # torch would widen an int32 sum
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return _reduce_distance_matrix(distance, reduction)


__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
]
