"""``ConfusionMatrix`` (counterpart of
``metrics_tpu/classification/confusion_matrix.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _ALLOWED_NORMALIZE,
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class ConfusionMatrix(Metric):
    """The confusion matrix as an int32 ``(C, C)`` sum state, or
    ``(C, 2, 2)`` with ``multilabel=True``; its counts come from K2 on the
    card. Members that hold the same ``confmat`` state (``CohenKappa``,
    ``MatthewsCorrCoef``, ``JaccardIndex`` of the same classes) form one
    compute group in a ``MetricCollection``: one count per batch for all.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.05, 0.15], [0.1, 0.15, 0.7, 0.05],
        ...                       [0.3, 0.4, 0.2, 0.1], [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> metric = ConfusionMatrix(num_classes=4, device="cpu")
        >>> metric(preds, target)
        tensor([[1, 0, 0, 0],
                [0, 0, 1, 0],
                [0, 0, 0, 1],
                [0, 1, 0, 0]], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better: Optional[bool] = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        if normalize not in _ALLOWED_NORMALIZE:
            raise ValueError(f"Argument average needs to one of the following: {_ALLOWED_NORMALIZE}")

        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.confmat += _confusion_matrix_update(preds, target, self.num_classes, self.threshold, self.multilabel)

    def compute(self) -> Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)
