"""Multilabel ranking metrics (counterpart of
``metrics_tpu/functional/classification/ranking.py``): coverage error,
label ranking average precision and label ranking loss.

Label ranking average precision ranks by pairwise comparisons,
``rank(x_i in S) = #{j in S : x_j <= x_i}`` (ties take the highest rank),
in one ``(N, L, L)`` reduction; the scores are flushed of float32 denormals
first, as XLA compares them. The label ranking loss ranks each row with
:func:`~metrics_tpu_torch.ops.bucketed_rank.ascending_ranks_rows`, bitwise
``jax.vmap(ascending_ranks)``, so ties rank as in the JAX package.

A ``sample_weight`` total is compared with zero in the compute step, which
reads it back to the host.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.bucketed_rank import ascending_ranks_rows, flush_denormals

Tensor = torch.Tensor


def _check_ranking_input(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
    if preds.ndim != 2 or target.ndim != 2:
        raise ValueError(
            "Expected both predictions and target to matrices of shape `[N,C]`"
            f" but got {preds.ndim} and {target.ndim}"
        )
    if preds.shape != target.shape:
        raise ValueError("Expected both predictions and target to have same shape")
    if sample_weight is not None:
        if sample_weight.ndim != 1 or sample_weight.shape[0] != preds.shape[0]:
            raise ValueError(
                "Expected sample weights to be 1 dimensional and have same size"
                f" as the first dimension of preds and target but got {tuple(sample_weight.shape)}"
            )


def _inputs(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor]) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    if sample_weight is not None:
        sample_weight = torch.as_tensor(sample_weight, device=preds.device)
    _check_ranking_input(preds, target, sample_weight)
    return preds, target, sample_weight


def _weighted(rows: Tensor, sample_weight: Optional[Tensor]) -> Tuple[Tensor, Optional[Tensor]]:
    if sample_weight is None:
        return rows.sum(), None
    return (rows * sample_weight).sum(), sample_weight.sum()


def _ranking_compute(score: Tensor, n_elements: int, sample_weight: Optional[Tensor] = None) -> Tensor:
    """The score over the weight total, or over the row count when there
    is no weight or it is zero (a host read of the total)."""
    if sample_weight is not None and bool(sample_weight != 0.0):
        return score / sample_weight
    return score / n_elements


def _coverage_error_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    """Per row, how many labels score at least the lowest relevant one."""
    preds, target, sample_weight = _inputs(preds, target, sample_weight)
    offset = torch.where(target == 0, torch.abs(preds.min()) + 10, 0.0)
    preds_mod = preds + offset
    preds_min = preds_mod.amin(dim=1)
    coverage = torch.sum(flush_denormals(preds) >= flush_denormals(preds_min)[:, None], dim=1).to(torch.float32)
    score, sample_weight = _weighted(coverage, sample_weight)
    return score, coverage.numel(), sample_weight


_coverage_error_compute = _ranking_compute


def coverage_error(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Multilabel coverage error.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.1, 0.9, 0.3]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> coverage_error(preds, target)
        tensor(1.5000)
    """
    coverage, n_elements, sample_weight = _coverage_error_update(preds, target, sample_weight)
    return _coverage_error_compute(coverage, n_elements, sample_weight)


def _label_ranking_average_precision_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    """Per row, the mean over relevant labels of the share of relevant
    labels among those ranked at or above it."""
    preds, target, sample_weight = _inputs(preds, target, sample_weight)
    neg_preds = flush_denormals(-preds)
    n_preds, n_labels = neg_preds.shape
    relevant = target == 1

    le = neg_preds[:, None, :] <= neg_preds[:, :, None]  # (N, i, j): x_j <= x_i
    rank_all = torch.sum(le, dim=2)
    rank_rel = torch.sum(le & relevant[:, None, :], dim=2)

    n_rel = relevant.sum(dim=1)
    ratio = torch.where(relevant, rank_rel / rank_all, 0.0)
    score_rows = torch.where(
        (n_rel > 0) & (n_rel < n_labels),
        ratio.sum(dim=1) / torch.clamp(n_rel, min=1),
        1.0,
    )
    score, sample_weight = _weighted(score_rows, sample_weight)
    return score, n_preds, sample_weight


_label_ranking_average_precision_compute = _ranking_compute


def label_ranking_average_precision(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Label ranking average precision.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.1, 0.9, 0.3]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> label_ranking_average_precision(preds, target)
        tensor(1.)
    """
    score, n_elements, sample_weight = _label_ranking_average_precision_update(preds, target, sample_weight)
    return _label_ranking_average_precision_compute(score, n_elements, sample_weight)


def _label_ranking_loss_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    """Per row, the share of (relevant, irrelevant) label pairs ordered
    wrongly; a row with no relevant or no irrelevant label counts 0."""
    preds, target, sample_weight = _inputs(preds, target, sample_weight)
    n_preds, n_labels = preds.shape
    relevant = target == 1
    n_relevant = relevant.sum(dim=1)
    mask = (n_relevant > 0) & (n_relevant < n_labels)

    inverse = ascending_ranks_rows(preds)
    per_label_loss = ((n_labels - inverse) * relevant).to(torch.float32)
    correction = 0.5 * n_relevant * (n_relevant + 1)
    denom = n_relevant * (n_labels - n_relevant)
    loss = (per_label_loss.sum(dim=1) - correction) / torch.clamp(denom, min=1)
    loss = torch.where(mask, loss, 0.0)
    score, sample_weight = _weighted(loss, sample_weight)
    return score, n_preds, sample_weight


_label_ranking_loss_compute = _ranking_compute


def label_ranking_loss(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Label ranking loss.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.8, 0.2, 0.6], [0.1, 0.9, 0.3]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> label_ranking_loss(preds, target)
        tensor(0.)
    """
    loss, n_elements, sample_weight = _label_ranking_loss_update(preds, target, sample_weight)
    return _label_ranking_loss_compute(loss, n_elements, sample_weight)
