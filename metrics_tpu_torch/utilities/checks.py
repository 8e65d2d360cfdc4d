"""Input validation and canonicalisation for classification inputs
(counterpart of ``metrics_tpu/utilities/checks.py``).

PyTorch runs eagerly, so the value checks (label ranges, non-negative
inputs) run on every call, where the JAX package skips them inside ``jit``.
Each value check reads one number back from the device. A metric guarded
by the fault channel (``on_invalid`` other than ``"ignore"``) runs its
update inside :func:`value_checks_off`: the checks are skipped, nothing is
read back, and the channel counts the label and non-finite faults instead,
as on the JAX package's compiled path (stated difference D1).
"""
import contextlib
import contextvars
from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops.bucketed_rank import flush_denormals
from metrics_tpu_torch.utilities.data import select_topk, to_onehot
from metrics_tpu_torch.utilities.enums import DataType

Tensor = torch.Tensor

_VALUE_CHECKS = contextvars.ContextVar("metrics_tpu_torch_value_checks", default=True)


@contextlib.contextmanager
def value_checks_off() -> Iterator[None]:
    """Skip the value checks that read the inputs back, inside the block."""
    token = _VALUE_CHECKS.set(False)
    try:
        yield
    finally:
        _VALUE_CHECKS.reset(token)


def _value_checks() -> bool:
    return _VALUE_CHECKS.get()


def _check_for_empty_tensors(preds: Tensor, target: Tensor) -> bool:
    return preds.numel() == 0 and target.numel() == 0


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Both inputs of one shape, else a ``RuntimeError`` naming the two."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _basic_input_validation(
    preds: Tensor, target: Tensor, threshold: float, multiclass: Optional[bool], ignore_index: Optional[int]
) -> None:
    """Case-independent validation."""
    if _check_for_empty_tensors(preds, target):
        return

    if target.is_floating_point():
        raise ValueError("The `target` has to be an integer tensor.")

    preds_float = preds.is_floating_point()

    if preds.shape[0] != target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")
    if not _value_checks():
        return

    tmin = int(target.min())
    if ignore_index is None and tmin < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if ignore_index is not None and ignore_index >= 0 and tmin < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if not preds_float and int(preds.min()) < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if multiclass is False and int(target.max()) > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")
    if multiclass is False and not preds_float and int(preds.max()) > 1:
        raise ValueError(
            "If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1."
        )


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> Tuple[DataType, int]:
    """Resolve the input case from shape and dtype."""
    preds_float = preds.is_floating_point()

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                f"The `preds` and `target` should have the same shape, "
                f"got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if preds_float and target.numel() > 0 and _value_checks() and int(target.max()) > 1:
            raise ValueError(
                "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
            )
        if preds.ndim == 1 and preds_float:
            case = DataType.BINARY
        elif preds.ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif preds.ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS
        implied_classes = (preds.numel() // preds.shape[0]) if preds.numel() > 0 else 0
    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        implied_classes = preds.shape[1] if preds.numel() > 0 else 0
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )

    return case, implied_classes


def _check_num_classes_binary(num_classes: int, multiclass: Optional[bool]) -> None:
    if num_classes > 2:
        raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
    if num_classes == 2 and not multiclass:
        raise ValueError(
            "Your data is binary and `num_classes=2`, but `multiclass` is not True."
            " Set it to True if you want to transform binary data to multi-class format."
        )
    if num_classes == 1 and multiclass:
        raise ValueError(
            "You have binary data and have set `multiclass=True`, but `num_classes` is 1."
            " Either set `multiclass=None` (default) or set `num_classes=2`"
            " to transform binary data to multi-class format."
        )


def _check_num_classes_mc(
    preds: Tensor, target: Tensor, num_classes: int, multiclass: Optional[bool], implied_classes: int
) -> None:
    if num_classes == 1 and multiclass is not False:
        raise ValueError(
            "You have set `num_classes=1`, but predictions are integers."
            " If you want to convert (multi-dimensional) multi-class data with 2 classes"
            " to binary/multi-label, set `multiclass=False`."
        )
    if num_classes > 1:
        if multiclass is False and implied_classes != num_classes:
            raise ValueError(
                "You have set `multiclass=False`, but the implied number of classes"
                " (from shape of inputs) does not match `num_classes`."
            )
        if target.numel() > 0 and _value_checks() and num_classes <= int(target.max()):
            raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
        if preds.shape != target.shape and num_classes != implied_classes:
            raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")


def _check_num_classes_ml(num_classes: int, multiclass: Optional[bool], implied_classes: int) -> None:
    if multiclass and num_classes != 2:
        raise ValueError(
            "Your have set `multiclass=True`, but `num_classes` is not equal to 2."
            " If you are trying to transform multi-label data to 2 class multi-dimensional"
            " multi-class, you should set `num_classes` to either 2 or None."
        )
    if not multiclass and num_classes != implied_classes:
        raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")


def _check_top_k(top_k: int, case: DataType, implied_classes: int, multiclass: Optional[bool], preds_float: bool) -> None:
    if case == DataType.BINARY:
        raise ValueError("You can not use `top_k` parameter with binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("The `top_k` has to be an integer larger than 0.")
    if not preds_float:
        raise ValueError("You have set `top_k`, but you do not have probability predictions.")
    if multiclass is False:
        raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError(
            "If you want to transform multi-label data to 2 class multi-dimensional"
            "multi-class data using `multiclass=True`, you can not use `top_k`."
        )
    if top_k >= implied_classes:
        raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> DataType:
    """Full input-consistency check; returns the resolved case."""
    _basic_input_validation(preds, target, threshold, multiclass, ignore_index)
    case, implied_classes = _check_shape_and_type_consistency(preds, target)

    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "You have set `multiclass=False`, but have more than 2 classes in your data,"
                " based on the C dimension of `preds`."
            )
        if target.numel() > 0 and _value_checks() and int(target.max()) >= implied_classes:
            raise ValueError(
                "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
            )

    if num_classes:
        if case == DataType.BINARY:
            _check_num_classes_binary(num_classes, multiclass)
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            _check_num_classes_mc(preds, target, num_classes, multiclass, implied_classes)
        elif case == DataType.MULTILABEL:
            _check_num_classes_ml(num_classes, multiclass, implied_classes)

    if top_k is not None:
        _check_top_k(top_k, case, implied_classes, multiclass, preds.is_floating_point())

    return case


def _check_retrieval_target_and_prediction_types(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Dtype and value checks of a retrieval pair; both flattened, ``preds``
    as float32, ``target`` as int32 (float32 when non-binary targets are
    allowed). The binary-values check reads the target's range back (a
    value check, skipped inside :func:`value_checks_off`)."""
    if target.is_floating_point() and not allow_non_binary_target:
        raise ValueError("`target` must be a tensor of booleans or integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if not allow_non_binary_target and _value_checks() and target.numel():
        bounds = torch.stack([target.max(), target.min()]).to(torch.int64).tolist()
        if bounds[0] > 1 or bounds[1] < 0:
            raise ValueError("`target` must contain `binary` values")
    target = target.to(torch.float32) if allow_non_binary_target else target.to(torch.int32)
    return preds.to(torch.float32).reshape(-1), target.reshape(-1)


def _check_retrieval_functional_inputs(
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
) -> Tuple[Tensor, Tensor]:
    """The checks of one query's ``(preds, target)`` pair."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.numel() == 0 or preds.ndim == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The checks of an ``(indexes, preds, target)`` triple, the rows whose
    target is ``ignore_index`` left out (a boolean gather, which reads the
    count back), all three flattened; ``indexes`` as int32."""
    indexes, preds, target = torch.as_tensor(indexes), torch.as_tensor(preds), torch.as_tensor(target)
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if indexes.is_floating_point() or indexes.is_complex() or indexes.dtype == torch.bool:
        raise ValueError("`indexes` must be a tensor of long integers")

    if ignore_index is not None:
        keep = target != ignore_index
        indexes, preds, target = indexes[keep], preds[keep], target[keep]

    if indexes.numel() == 0 or indexes.ndim == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")

    preds, target = _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)
    return indexes.to(torch.int32).reshape(-1), preds, target


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Remove excess size-1 dimensions, keeping the batch axis."""
    if preds.shape and preds.shape[0] == 1:
        preds = preds.squeeze().unsqueeze(0)
        target = target.squeeze().unsqueeze(0)
    else:
        preds, target = preds.squeeze(), target.squeeze()
    return preds, target


def _at_or_above(preds: Tensor, threshold: float) -> Tensor:
    """``preds >= threshold`` as XLA compares on the CPU and the TPU: a
    float32 denormal, score or threshold, counts as zero."""
    if preds.dtype != torch.float32:
        return preds >= threshold
    # the threshold is flushed on the host: a device tensor would cost a copy
    # and a stream synchronize on every update
    thr = float(np.float32(threshold))
    if abs(thr) < np.finfo(np.float32).tiny:
        thr = 0.0
    return flush_denormals(preds) >= thr


def _infer_num_classes(preds: Tensor, target: Tensor) -> int:
    return int(max(int(preds.max()), int(target.max())) + 1)


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Canonicalise ``(preds, target)`` into dense binary int32 ``(N, C)`` /
    ``(N, C, X)`` tensors."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    preds, target = _input_squeeze(preds, target)

    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)

    case = _check_classification_inputs(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
    )

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = _at_or_above(preds, threshold).to(torch.int32)
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if preds.is_floating_point():
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            num_classes = num_classes if num_classes else _infer_num_classes(preds, target)
            preds = to_onehot(preds, max(2, num_classes))

        target = to_onehot(target, max(2, num_classes))

        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if not _check_for_empty_tensors(preds, target):
        if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
            target = target.reshape(target.shape[0], target.shape[1], -1)
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
        else:
            target = target.reshape(target.shape[0], -1)
            preds = preds.reshape(preds.shape[0], -1)

    # drop the trailing X=1 axis created above for plain (N, C) cases
    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    return preds.to(torch.int32), target.to(torch.int32), case


def _allclose_recursive(res1: Any, res2: Any, atol: float = 1e-6) -> bool:
    """Elementwise closeness over nested dict/sequence results."""
    if isinstance(res1, dict):
        return all(_allclose_recursive(res1[k], res2[k], atol) for k in res1)
    if isinstance(res1, (list, tuple)):
        return all(_allclose_recursive(r1, r2, atol) for r1, r2 in zip(res1, res2))

    def host(x: Any) -> np.ndarray:
        return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)

    return bool(np.allclose(host(res1), host(res2), atol=atol, equal_nan=True))


def check_forward_full_state_property(
    metric_class: Any,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare: Sequence[int] = (10, 100, 1000),
    reps: int = 5,
) -> None:
    """Whether ``full_state_update=False`` is safe, and faster, for a metric
    class: its ``forward`` runs under both protocols on the same inputs; if
    the batch values and the final ``compute()`` agree, both are timed and
    the recommended flag is printed.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ConfusionMatrix
        >>> g = torch.Generator().manual_seed(0)
        >>> check_forward_full_state_property(
        ...     ConfusionMatrix,
        ...     init_args={'num_classes': 3, 'device': 'cpu'},
        ...     input_args={'preds': torch.randint(3, (10,), generator=g), 'target': torch.randint(3, (10,), generator=g)},
        ...     num_update_to_compare=(2, 4),
        ...     reps=2,
        ... )  # doctest: +ELLIPSIS
        Full state for 2 steps took: ...
        Recommended setting `full_state_update=...`
    """
    from time import perf_counter

    from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError

    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):
        full_state_update = True

    class PartState(metric_class):
        full_state_update = False

    fullstate = FullState(**init_args)
    partstate = PartState(**init_args)

    equal = True
    for _ in range(num_update_to_compare[0]):
        out1 = fullstate(**input_args)
        try:  # a failure usually means the update needs the full prior state
            out2 = partstate(**input_args)
        except (RuntimeError, MetricsTPUUserError):
            equal = False
            break
        equal = equal and _allclose_recursive(out1, out2)

    if equal:
        res1 = fullstate.compute()
        try:
            res2 = partstate.compute()
        except (RuntimeError, MetricsTPUUserError):
            equal = False
        else:
            equal = equal and _allclose_recursive(res1, res2)

    if not equal:
        print("Recommended setting `full_state_update=True`")
        return

    timings = np.zeros((2, len(num_update_to_compare), reps))
    for i, metric in enumerate((fullstate, partstate)):
        for j, steps in enumerate(num_update_to_compare):
            for r in range(reps):
                start = perf_counter()
                for _ in range(steps):
                    metric(**input_args)
                timings[i, j, r] = perf_counter() - start
                metric.reset()

    mean = timings.mean(-1)
    std = timings.std(-1)
    for j, steps in enumerate(num_update_to_compare):
        print(f"Full state for {steps} steps took: {mean[0, j]:0.3f}+-{std[0, j]:0.3f}")
        print(f"Partial state for {steps} steps took: {mean[1, j]:0.3f}+-{std[1, j]:0.3f}")

    faster = bool(mean[1, -1] < mean[0, -1])
    print(f"Recommended setting `full_state_update={not faster}`")
