"""The Jaccard index (counterpart of
``metrics_tpu/functional/classification/jaccard.py``): intersection over
union from the confusion matrix, whose counts come from K2 on the card."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

Tensor = torch.Tensor


def _jaccard_from_confmat(
    confmat: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
) -> Tensor:
    """Intersection over union per class, averaged; the row of
    ``ignore_index`` is zeroed and its score left out."""
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

    confmat = torch.as_tensor(confmat)
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes
    if ignored:
        confmat = confmat.clone()
        confmat[ignore_index] = 0

    if average in ("none", None):
        intersection = torch.diagonal(confmat)
        union = confmat.sum(0) + confmat.sum(1) - intersection
        empty = union == 0
        scores = intersection.to(torch.float32) / torch.where(empty, 1, union).to(torch.float32)
        scores = torch.where(empty, float(absent_score), scores)
        if ignored:
            scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1 :]])
        return scores

    if average == "macro":
        scores = _jaccard_from_confmat(confmat, num_classes, average="none", ignore_index=ignore_index, absent_score=absent_score)
        return torch.mean(scores)

    if average == "micro":
        intersection = torch.sum(torch.diagonal(confmat))
        union = torch.sum(confmat.sum(0) + confmat.sum(1) - torch.diagonal(confmat))
        return intersection.to(torch.float32) / union.to(torch.float32)

    weights = confmat.sum(dim=1).to(torch.float32) / confmat.sum().to(torch.float32)
    scores = _jaccard_from_confmat(confmat, num_classes, average="none", ignore_index=None, absent_score=absent_score)
    return torch.sum(weights * scores)


def jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
) -> Tensor:
    """The Jaccard index (intersection over union).

    Example:
        >>> import torch
        >>> target = torch.tensor([[0, 1, 1], [1, 1, 0]])
        >>> preds = torch.tensor([[0, 1, 0], [1, 1, 1]])
        >>> jaccard_index(preds, target, num_classes=2).round(decimals=4)
        tensor(0.4667)
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _jaccard_from_confmat(confmat, num_classes, average, ignore_index, absent_score)
