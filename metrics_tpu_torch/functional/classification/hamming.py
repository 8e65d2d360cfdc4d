"""The Hamming distance (counterpart of
``metrics_tpu/functional/classification/hamming.py``)."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utilities.checks import _input_format_classification

Tensor = torch.Tensor


def _hamming_distance_update(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tuple[Tensor, int]:
    """The int32 count of positions where the canonical prediction equals
    the target, and the number of positions."""
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    correct = torch.sum(preds == target).to(torch.int32)
    total = preds.numel()
    return correct, total


def _hamming_distance_compute(correct: Tensor, total: Union[int, Tensor]) -> Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tensor:
    """The share of wrongly predicted labels.

    Example:
        >>> import torch
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming_distance(preds, target)
        tensor(0.2500)
    """
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)
