"""Cohen's kappa (counterpart of
``metrics_tpu/functional/classification/cohen_kappa.py``): from the
confusion matrix, whose counts come from K2 on the card."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)

Tensor = torch.Tensor

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """Kappa from a confusion matrix, in float32 (the sums over the C^2
    cells run in another order than XLA's: stated difference D2)."""
    weights = None if weights == "none" else weights
    confmat = _confusion_matrix_compute(confmat)
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 @ sum0 / sum0.sum()

    if weights is None:
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[None, :] - idx[:, None]
        w_mat = torch.abs(diff) if weights == "linear" else diff**2
    else:
        raise ValueError(f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'")

    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
) -> Tensor:
    """Cohen's kappa: agreement between predictions and labels beyond chance.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> cohen_kappa(preds, target, num_classes=2)
        tensor(0.5000)
    """
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)
