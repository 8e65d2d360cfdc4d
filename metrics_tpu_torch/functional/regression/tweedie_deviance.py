"""Tweedie deviance (counterpart of
``metrics_tpu/functional/regression/tweedie_deviance.py``).

The checks of the value domain for each power read the inputs back, so
they run only where the value checks do (not under ``value_checks_off``:
the JAX package checks only concrete arrays).
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape, _value_checks
from metrics_tpu_torch.utilities.compute import _safe_xlogy

Tensor = torch.Tensor


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    targets = torch.as_tensor(targets)
    _check_same_shape(preds, targets)

    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")

    checks = _value_checks()
    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:
        if checks and (bool((preds <= 0).any()) or bool((targets < 0).any())):
            raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        if checks and (bool((preds <= 0).any()) or bool((targets <= 0).any())):
            raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        if checks:
            if power < 0 and bool((preds <= 0).any()):
                raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
            if 1 < power < 2 and (bool((preds <= 0).any()) or bool((targets < 0).any())):
                raise ValueError(
                    f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative."
                )
            if power > 2 and (bool((preds <= 0).any()) or bool((targets <= 0).any())):
                raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")

        term_1 = torch.pow(torch.clamp(targets, min=0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / (1 - power)
        term_3 = torch.pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    sum_deviance_score = torch.sum(deviance_score)
    num_observations = torch.tensor(deviance_score.numel(), dtype=torch.int32, device=deviance_score.device)
    return sum_deviance_score, num_observations


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Mean Tweedie deviance for ``power`` (0 normal, 1 Poisson, 2 gamma).

    Example:
        >>> import torch
        >>> targets = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([4.0, 3.0, 2.0, 1.0])
        >>> print(f"{tweedie_deviance_score(preds, targets, power=2):.4f}")
        1.2083
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
