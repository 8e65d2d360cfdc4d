"""Matthews correlation coefficient (counterpart of
``metrics_tpu/functional/classification/matthews_corrcoef.py``): from the
confusion matrix, whose counts come from K2 on the card."""
import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

Tensor = torch.Tensor

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: Tensor) -> Tensor:
    """MCC from a confusion matrix, in float32; 0 where the denominator is."""
    confmat = confmat.to(torch.float32)
    tk = confmat.sum(dim=1)
    pk = confmat.sum(dim=0)
    c = torch.trace(confmat)
    s = confmat.sum()

    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)

    denom = cov_ypyp * cov_ytyt
    zero = denom == 0
    return torch.where(zero, 0.0, cov_ytyp / torch.sqrt(torch.where(zero, 1.0, denom)))


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    threshold: float = 0.5,
) -> Tensor:
    """Matthews correlation coefficient.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews_corrcoef(preds, target, num_classes=2)
        tensor(0.5774)
    """
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
