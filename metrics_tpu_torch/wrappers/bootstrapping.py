"""``BootStrapper`` (counterpart of ``metrics_tpu/wrappers/bootstrapping.py``).

The JAX package draws the resample indices from numpy's global generator;
the port draws them from a ``torch.Generator`` (``generator=``, by default
torch's global CPU generator), on the generator's device, and moves them
to the data's. Drawing and updating are apart: :meth:`BootStrapper.update`
draws one index vector per copy and hands them to
:meth:`BootStrapper._update_with_indices`, which a caller (a parity test,
a replay) can feed with indices drawn elsewhere.
"""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import apply_to_collection

Tensor = torch.Tensor

_ARRAY_TYPES = (Tensor, np.ndarray)


def _bootstrap_sampler(size: int, sampling_strategy: str = "poisson", generator: Optional[torch.Generator] = None) -> Tensor:
    """Indices that resample ``size`` rows with replacement: each row
    repeated a Poisson(1) number of times, or ``size`` uniform draws."""
    device = generator.device if generator is not None else torch.device("cpu")
    if sampling_strategy == "poisson":
        n = torch.poisson(torch.ones(size, device=device), generator=generator).to(torch.int64)
        return torch.repeat_interleave(torch.arange(size, device=device), n)
    if sampling_strategy == "multinomial":
        return torch.randint(0, size, (size,), generator=generator, device=device)
    raise ValueError("Unknown sampling strategy")


class BootStrapper(Metric):
    """Confidence intervals from ``num_bootstraps`` copies of a metric, each
    updated on a resample of every batch. ``compute`` returns the mean and
    the standard deviation (``ddof=1``) of the copies' values, and on
    request a quantile and the raw values. It runs on the base metric's
    device unless ``device`` says otherwise; the pure layer refuses it
    (``bootstrap_functionalize`` is its vectorized form).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> bootstrap = BootStrapper(Accuracy(device="cpu"), num_bootstraps=20, generator=torch.Generator().manual_seed(123))
        >>> bootstrap.update(torch.randint(0, 5, (20,)), torch.randint(0, 5, (20,)))
        >>> sorted(bootstrap.compute())
        ['mean', 'std']
    """

    jittable_update = False
    jittable_compute = False

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        generator: Optional[torch.Generator] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw

        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self.generator = generator

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Draw one resample of the batch's rows for each copy, then update
        the copies on them."""
        args_sizes = apply_to_collection(args, _ARRAY_TYPES, len)
        kwargs_sizes = list(apply_to_collection(kwargs, _ARRAY_TYPES, len).values())
        if len(args_sizes) > 0:
            size = args_sizes[0]
        elif len(kwargs_sizes) > 0:
            size = kwargs_sizes[0]
        else:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        indices = [_bootstrap_sampler(size, self.sampling_strategy, self.generator) for _ in range(self.num_bootstraps)]
        self._update_with_indices(indices, *args, **kwargs)

    def _update_with_indices(self, indices: List[Any], *args: Any, **kwargs: Any) -> None:
        """Update copy ``i`` on every input's rows ``indices[i]``."""
        for metric, sample_idx in zip(self.metrics, indices):
            sample_idx = torch.as_tensor(sample_idx, device=self.device)

            def take(x: Any, _idx: Tensor = sample_idx) -> Tensor:
                return self._to_device(x)[_idx]

            metric.update(*apply_to_collection(args, _ARRAY_TYPES, take), **apply_to_collection(kwargs, _ARRAY_TYPES, take))

    def compute(self) -> Dict[str, Tensor]:
        computed_vals = torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            output_dict["quantile"] = torch.quantile(computed_vals, torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device))
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()
