"""``StatScores`` (counterpart of ``metrics_tpu/classification/stat_scores.py``)."""
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_compute, _stat_scores_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class StatScores(Metric):
    """Accumulate tp/fp/tn/fn counts: int32 sum states, ``()`` for micro and
    ``(C,)`` for macro, or ``cat`` lists for per-sample reductions.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.05, 0.15], [0.1, 0.15, 0.7, 0.05],
        ...                       [0.3, 0.4, 0.2, 0.1], [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> StatScores(reduce='micro', device='cpu')(preds, target)
        tensor([1, 3, 9, 3, 4], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    @property
    def _valid_mask_always(self) -> bool:
        """Whether this instance's update takes ``valid`` row masks: not
        for per-sample reductions (one output row per input row) nor for a
        negative ``ignore_index`` (rows dropped by boolean indexing)."""
        if self.reduce == "samples" or self.mdmc_reduce == "samplewise":
            return False
        return self.ignore_index is None or self.ignore_index >= 0

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        if mdmc_reduce != "samplewise" and reduce != "samples":
            shape = () if reduce == "micro" else (num_classes,)
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(s, default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")
        else:
            # a rank with no batch gathers this template, so its rows must
            # have the dtype and number of dimensions of the others'
            template = torch.zeros(self._list_row_shape(), dtype=torch.int32)
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(s, default=[], dist_reduce_fx="cat", template=template)

    def _list_row_shape(self) -> Tuple[int, ...]:
        """``(0, *row)`` of one appended batch of the per-sample states: a
        samplewise reduction of ``(N, C, X)`` inputs counts ``(N,)`` (micro),
        ``(N, C)`` (macro) or ``(N, X)`` (samples, X known only from the
        data: 0 here, and the gather pads it); ``reduce="samples"`` alone
        counts ``(N,)``."""
        if self.mdmc_reduce != "samplewise" or self.reduce == "micro":
            return (0,)
        return (0, self.num_classes) if self.reduce == "macro" else (0, 0)

    def update(self, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> None:
        """Accumulate a batch's counts; a row that the bool ``(N,)``
        ``valid`` mask leaves out adds to no counter."""
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
            valid=valid,
        )
        if self.reduce != "samples" and self.mdmc_reduce != "samplewise":
            self.tp += tp
            self.fp += fp
            self.tn += tn
            self.fn += fn
        else:
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)

    def _get_final_stats(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Concatenate list states, pass tensors through."""
        tp = dim_zero_cat(self.tp) if isinstance(self.tp, list) else self.tp
        fp = dim_zero_cat(self.fp) if isinstance(self.fp, list) else self.fp
        tn = dim_zero_cat(self.tn) if isinstance(self.tn, list) else self.tn
        fn = dim_zero_cat(self.fn) if isinstance(self.fn, list) else self.fn
        return tp, fp, tn, fn

    def compute(self) -> Tensor:
        """The [tp, fp, tn, fn, support] stack."""
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)
