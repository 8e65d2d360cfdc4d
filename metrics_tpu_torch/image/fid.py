"""``FrechetInceptionDistance`` (counterpart of ``metrics_tpu/image/fid.py``).

``feature`` is a callable ``images -> (N, D) features`` (the reference's
path is :class:`metrics_tpu_torch.nets.InceptionV3Extractor`, seeded random
weights unless a checkpoint is loaded) or an int feature width, and then
``update`` takes features as they are.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.image.fid import _compute_fid_with_rung, _mean_cov, _mean_cov_masked
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append, reject_valid_kwarg

Tensor = torch.Tensor


def _append_real_fake(metric: Any, features: Tensor, real: Any, valid: Optional[Tensor]) -> None:
    """The capacity mode's append (FID and KID): ``real`` (a bool, or a
    bool tensor) routes the rows to the real or the fake ring by mask, with
    no branch on its value, as JAX's append does. A Python ``real`` becomes
    a fill on the card, not a copy from the host, so the update stays
    capturable (and keys one graph a side)."""
    device = features.device
    is_real = real.to(device=device, dtype=torch.bool) if isinstance(real, Tensor) else torch.full((), bool(real), dtype=torch.bool, device=device)
    v = torch.ones(features.shape[0], dtype=torch.bool, device=device) if valid is None else valid.to(torch.bool)
    metric.real_features = cat_append(metric.real_features, features, v & is_real)
    metric.fake_features = cat_append(metric.fake_features, features, v & ~is_real)


def _feature_dim_of(feature: Union[int, Callable], capacity_owner: str) -> int:
    """The fixed feature width that a ring needs at construction."""
    if isinstance(feature, int):
        return feature
    dim = getattr(feature, "feature_dim", None)
    if not isinstance(dim, int):
        raise ValueError(
            f"{capacity_owner}(capacity=...) needs a static feature width: pass `feature` as an "
            "int (pre-extracted features) or an extractor exposing an integer `.feature_dim` "
            "(InceptionV3Extractor and TinyImageEncoder both do)."
        )
    return dim


def _init_feature_states(metric: Metric, feature: Union[int, Callable], capacity: Optional[int], owner: str) -> None:
    """The real and fake feature states of FID and KID: ``cat`` lists, or
    with ``capacity`` two float32 rings, and then the update is capturable."""
    if capacity is not None:
        dim = _feature_dim_of(feature, owner)
        metric.add_state("real_features", default=CatBuffer.zeros(capacity, (dim,), torch.float32), dist_reduce_fx="cat")
        metric.add_state("fake_features", default=CatBuffer.zeros(capacity, (dim,), torch.float32), dist_reduce_fx="cat")
        object.__setattr__(metric, "jittable_update", True)
        object.__setattr__(metric, "jittable_compute", True)
    else:
        metric.add_state("real_features", default=[], dist_reduce_fx=None, template=None)
        metric.add_state("fake_features", default=[], dist_reduce_fx=None, template=None)


def _extractor_of(feature: Union[int, Callable]) -> Optional[Callable]:
    if callable(feature):
        return feature
    if isinstance(feature, int):
        return None  # update() receives features
    raise TypeError("Got unknown input to argument `feature`")


def _features(metric: Any, imgs: Tensor) -> Tensor:
    features = metric.extractor(imgs) if metric.extractor is not None else torch.as_tensor(imgs)
    if features.ndim != 2:
        raise ValueError(f"Expected extracted features to be 2d (N, D), got shape {tuple(features.shape)}")
    return features


def _reset_keeping_real(metric: Metric, reset: Callable[[], None]) -> None:
    """``reset`` that keeps the real features with ``reset_real_features=False``."""
    if metric.reset_real_features:
        reset()
        return
    real_features = metric._state["real_features"]
    reset()
    # graft-lint: disable=GL301 — restoring a leaf add_state already
    # declared (the reference's reset_real_features=False contract)
    metric._state["real_features"] = real_features


class FrechetInceptionDistance(Metric):
    """FID between the real and the fake features.

    Two modes: the default keeps the features in lists (eager update); with
    ``capacity=N`` two ``(N, D)`` rings (``real``, a bool or a bool tensor,
    routes the rows by mask; ``valid`` masks rows), an update that is
    captured on the card like every other, and a masked mean and
    covariance. Rows past capacity are dropped and counted; with fewer than
    two valid rows a side's FID is NaN. ``ladder_rung`` names the rung of
    the square root's ladder (``functional/image/fid.py``) that the last
    ``compute()`` took.

    Example:
        >>> import torch
        >>> feats = torch.randn((16, 8), generator=torch.Generator().manual_seed(0))
        >>> ring = FrechetInceptionDistance(feature=8, capacity=32, device="cpu")
        >>> ring.update(feats, real=True)
        >>> ring.update(feats, real=False)
        >>> round(float(ring.compute()), 4)
        0.0
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    # list states and an extractor: eager (the capacity mode turns these on)
    jittable_update = False
    jittable_compute = False

    _independent_ring_drops = True

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.extractor = _extractor_of(feature)
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        self.capacity = capacity
        self.ladder_rung: Optional[str] = None
        _init_feature_states(self, feature, capacity, "FrechetInceptionDistance")

    def update(self, imgs: Tensor, real: Any, valid: Optional[Tensor] = None) -> None:
        """Extract (or take) the features and append them to the real or
        the fake side."""
        features = _features(self, imgs)
        if self.capacity is not None:
            _append_real_fake(self, features, real, valid)
            return
        reject_valid_kwarg(valid)
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def compute(self) -> Tensor:
        if self.capacity is not None:
            mu1, sigma1, _ = _mean_cov_masked(self.real_features.data, self.real_features.mask)
            mu2, sigma2, _ = _mean_cov_masked(self.fake_features.data, self.fake_features.mask)
            value, self.ladder_rung = _compute_fid_with_rung(mu1, sigma1, mu2, sigma2)
            return value
        real_features = dim_zero_cat(self.real_features).to(torch.float32)
        fake_features = dim_zero_cat(self.fake_features).to(torch.float32)
        if real_features.shape[0] < 2 or fake_features.shape[0] < 2:
            raise ValueError("More than one sample is required for both the real and fake distributed to compute FID")
        mu1, sigma1, xc = _mean_cov(real_features)
        mu2, sigma2, yc = _mean_cov(fake_features)
        value, self.ladder_rung = _compute_fid_with_rung(mu1, sigma1, mu2, sigma2, centered=(xc, yc))
        return value

    def reset(self) -> None:
        """Keeps the real features when ``reset_real_features`` is False."""
        _reset_keeping_real(self, super().reset)
