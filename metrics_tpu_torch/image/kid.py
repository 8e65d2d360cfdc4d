"""``KernelInceptionDistance`` (counterpart of ``metrics_tpu/image/kid.py``).

The list mode draws its subsets with numpy's global generator
(``np.random.permutation``), as JAX does, so one numpy seed gives the same
subsets in both packages. The capacity mode draws each subset as the top
``subset_size`` of uniform scores over the valid rows; JAX draws the scores
with ``jax.random`` keys folded from ``seed`` and the fill counts, which
torch cannot reproduce: the port draws them from a ``torch.Generator``
seeded from the same three numbers (stated difference D42), and keeps the
draw (:meth:`KernelInceptionDistance.draw_subsets`) apart from the MMD
(:meth:`KernelInceptionDistance.kid_from_indices`), so that a test can
feed JAX's indices.
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.image.fid import _poly_mmd
from metrics_tpu_torch.image.fid import (
    _append_real_fake,
    _extractor_of,
    _features,
    _init_feature_states,
    _reset_keeping_real,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.ringbuffer import reject_valid_kwarg

Tensor = torch.Tensor


def seeded_generator(device: torch.device, *words: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``words`` (a seed and
    fill counts), the same on every process and device."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & ((1 << 63) - 1))


class KernelInceptionDistance(Metric):
    """Polynomial-kernel MMD over random feature subsets: ``(mean, std)``.

    Two modes, as :class:`FrechetInceptionDistance`: feature lists with
    numpy's global draws, or ``capacity=N`` rings with a seeded draw on the
    metric's device. The capacity mode needs ``subset_size`` valid rows a
    side; with fewer its subsets take empty rows (JAX: the same).

    Example:
        >>> import numpy as np
        >>> import torch
        >>> rng = np.random.default_rng(0)
        >>> real = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
        >>> fake = torch.from_numpy((rng.standard_normal((30, 8)) + 1.0).astype(np.float32))
        >>> kid = KernelInceptionDistance(feature=8, subsets=1, subset_size=30, device="cpu")
        >>> kid.update(real, real=True)
        >>> kid.update(fake, real=False)
        >>> mean, std = kid.compute()
        >>> round(float(mean), 4)
        6.7037
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    jittable_update = False
    jittable_compute = False

    _independent_ring_drops = True

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        capacity: Optional[int] = None,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.extractor = _extractor_of(feature)
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        self.capacity = capacity
        self.seed = seed
        if capacity is not None and capacity < subset_size:
            raise ValueError(
                "Argument `capacity` must be at least `subset_size` — a saturated buffer "
                "could otherwise never hold a full subset"
            )
        _init_feature_states(self, feature, capacity, "KernelInceptionDistance")

    def update(self, imgs: Tensor, real: Any, valid: Optional[Tensor] = None) -> None:
        features = _features(self, imgs)
        if self.capacity is not None:
            _append_real_fake(self, features, real, valid)
            return
        reject_valid_kwarg(valid)
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def draw_subsets(self) -> Tuple[Tensor, Tensor]:
        """The capacity mode's subsets: ``(subsets, subset_size)`` row
        indices into the real and the fake ring, drawn among the valid rows
        from a generator seeded by ``seed`` and both fill counts (one read
        back)."""
        real, fake = self.real_features, self.fake_features
        n_real, n_fake = torch.stack([real.count(), fake.count()]).tolist()
        gen = seeded_generator(self.device, self.seed, n_real, n_fake)
        picks = []
        for ring in (real, fake):
            scores = torch.rand((self.subsets, ring.capacity), generator=gen, device=self.device)
            scores = torch.where(ring.mask[None, :], scores, float("-inf"))
            picks.append(torch.topk(scores, self.subset_size, dim=1).indices)
        return picks[0], picks[1]

    def kid_from_indices(self, real_idx: Tensor, fake_idx: Tensor) -> Tuple[Tensor, Tensor]:
        """KID mean and std over the subsets that the rows of ``real_idx``
        and ``fake_idx`` (``(subsets, subset_size)`` ring rows) pick."""
        real_idx = torch.as_tensor(real_idx, device=self.device).long()
        fake_idx = torch.as_tensor(fake_idx, device=self.device).long()
        scores = torch.stack([
            _poly_mmd(self.real_features.data[r], self.fake_features.data[f], self.degree, self.gamma, self.coef)
            for r, f in zip(real_idx, fake_idx)
        ])
        return scores.mean(), scores.std()

    def compute(self) -> Tuple[Tensor, Tensor]:
        if self.capacity is not None:
            return self.kid_from_indices(*self.draw_subsets())
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        kid_scores = []
        for _ in range(self.subsets):
            perm = torch.from_numpy(np.random.permutation(n_samples_real)[: self.subset_size]).to(real_features.device)
            f_real = real_features[perm]
            perm = torch.from_numpy(np.random.permutation(n_samples_fake)[: self.subset_size]).to(fake_features.device)
            f_fake = fake_features[perm]
            kid_scores.append(_poly_mmd(f_real, f_fake, self.degree, self.gamma, self.coef))
        scores = torch.stack(kid_scores)
        return scores.mean(), scores.std()

    def reset(self) -> None:
        """Keeps the real features when ``reset_real_features`` is False."""
        _reset_keeping_real(self, super().reset)
