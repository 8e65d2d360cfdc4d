"""Permutation-invariant training (counterpart of ``metrics_tpu/functional/audio/pit.py``).

The best permutation comes from one gather over the ``(S!, S)`` table of
every speaker permutation: the ``(batch, S, S)`` metric matrix, one
``take_along_dim`` and a mean give each permutation's score, and argmax (or
argmin) picks the winner. The table is built once per (S, device) and kept:
a copy from the host inside a CUDA-graph capture would fail. Scores are
compared through ``flush_denormals`` (a float32 denormal ties with zero, as
in XLA's compares); ties pick the first permutation in
``itertools.permutations`` order, and a NaN score wins an argmax and an
argmin, as ``jnp.argmax``/``jnp.argmin`` pick it.
"""
from itertools import permutations
from typing import Any, Callable, Dict, Tuple

import torch

from metrics_tpu_torch.ops.bucketed_rank import flush_denormals

Tensor = torch.Tensor

_TABLES: Dict[Tuple[int, torch.device], Tensor] = {}


def _permutation_table(spk_num: int, device: torch.device) -> Tensor:
    """The ``(S!, S)`` table of all speaker permutations on ``device``
    (int64), built at the first call for ``(spk_num, device)``."""
    key = (spk_num, torch.device(device))
    table = _TABLES.get(key)
    if table is None:
        table = torch.tensor(list(permutations(range(spk_num))), dtype=torch.int64, device=device)
        table = _TABLES.setdefault(key, table)
    return table


def permutation_invariant_training(
    preds: Tensor, target: Tensor, metric_func: Callable, eval_func: str = "max", **kwargs: Any
) -> Tuple[Tensor, Tensor]:
    """PIT: ``metric_func`` for every (target speaker, predicted speaker)
    pair, then the permutation with the best mean.

    Args:
        preds: ``[batch, spk, ...]`` estimates.
        target: ``[batch, spk, ...]`` references.
        metric_func: batch metric, called as ``metric_func(preds[:, i],
            target[:, j], **kwargs) -> [batch]``.
        eval_func: ``"max"`` or ``"min"``: whether larger is better.

    Returns:
        ``(best_metric [batch], best_perm [batch, spk])``, the permutation
        int64 (int32 in JAX, ROADMAP D65).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([[[-0.0579, 0.3560, -0.9604], [-0.1719, 0.3205, 0.2951]]])
        >>> target = torch.tensor([[[1.0958, -0.1648, 0.5228], [-0.4100, 1.1942, -0.5103]]])
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio, 'max')
        >>> print(f"{best_metric[0]:.4f}", best_perm[0].tolist())
        -5.1091 [0, 1]
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ("max", "min"):
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    spk_num = target.shape[1]
    # rows: target speaker, columns: predicted speaker
    rows = [
        torch.stack([metric_func(preds[:, p_idx, ...], target[:, t_idx, ...], **kwargs) for p_idx in range(spk_num)], dim=-1)
        for t_idx in range(spk_num)
    ]
    metric_mtx = torch.stack(rows, dim=-2)  # (batch, spk_t, spk_p)

    perms = _permutation_table(spk_num, metric_mtx.device)  # (P, S)
    index = perms.T[None].expand(metric_mtx.shape[0], spk_num, perms.shape[0])
    # entry [b, j, k] = metric_mtx[b, j, perms[k, j]]
    gathered = torch.take_along_dim(metric_mtx, index, dim=2)
    metric_of_ps = flush_denormals(gathered.mean(dim=1))  # (batch, P)

    if eval_func == "max":
        best_idx = torch.argmax(metric_of_ps, dim=-1)
    else:
        best_idx = torch.argmin(metric_of_ps, dim=-1)
    best_metric = torch.take_along_dim(metric_of_ps, best_idx[:, None], dim=-1)[:, 0]
    best_perm = perms[best_idx]
    return best_metric, best_perm


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """``preds``' speakers reordered by ``perm`` (``[batch, spk]``)."""
    preds = torch.as_tensor(preds)
    perm = torch.as_tensor(perm, device=preds.device).long()
    idx = perm.reshape(perm.shape + (1,) * (preds.ndim - 2)).expand(perm.shape + preds.shape[2:])
    return torch.take_along_dim(preds, idx, dim=1)
