"""``JaccardIndex`` (counterpart of ``metrics_tpu/classification/jaccard.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_from_confmat

Tensor = torch.Tensor


class JaccardIndex(ConfusionMatrix):
    """The Jaccard index (intersection over union) over an accumulated
    confusion matrix.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.05, 0.15], [0.1, 0.15, 0.7, 0.05],
        ...                       [0.3, 0.4, 0.2, 0.1], [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> metric = JaccardIndex(num_classes=4, device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.25
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, normalize=None, threshold=threshold, multilabel=multilabel, **kwargs)
        self.average = average
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> Tensor:
        return _jaccard_from_confmat(self.confmat, self.num_classes, self.average, self.ignore_index, self.absent_score)
