"""The hinge loss (counterpart of
``metrics_tpu/functional/classification/hinge.py``): binary, and
multi-class by Crammer-Singer or one-vs-all."""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utilities.checks import _input_squeeze
from metrics_tpu_torch.utilities.data import to_onehot
from metrics_tpu_torch.utilities.enums import DataType, EnumStr

Tensor = torch.Tensor


class MulticlassMode(EnumStr):
    """How the multi-class hinge loss is taken."""

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: Tensor, target: Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.BINARY
    elif preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.MULTICLASS
    else:
        raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")
    return mode


def _check_multiclass_mode(multiclass_mode: Optional[Union[str, MulticlassMode]]) -> None:
    if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
        raise ValueError(
            "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
            "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
            f" got {multiclass_mode}."
        )


def _hinge_update(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[Tensor, Tensor]:
    """The batch's summed hinge measure (``(C,)`` for one-vs-all) and its
    row count."""
    preds, target = _input_squeeze(torch.as_tensor(preds), torch.as_tensor(target))
    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        target = to_onehot(target, max(2, preds.shape[1])).to(torch.bool)

    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        # the margin: the true class's score less the best wrong score, per row
        true_score = torch.sum(torch.where(target, preds, 0.0), dim=1)
        best_wrong = torch.amax(torch.where(target, float("-inf"), preds), dim=1)
        margin = true_score - best_wrong
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        target = target.to(torch.bool)
        margin = torch.where(target, preds, -preds)
    else:
        _check_multiclass_mode(multiclass_mode)

    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures**2

    total = torch.full((), target.shape[0], dtype=torch.int32, device=preds.device)
    return measures.sum(dim=0), total


def _hinge_compute(measure: Tensor, total: Tensor) -> Tensor:
    return measure / total


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tensor:
    """The mean hinge loss.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> print(f"{hinge_loss(preds, target):.4f}")
        0.3000
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)
