"""``InceptionScore`` (counterpart of ``metrics_tpu/image/inception.py``).

The list mode shuffles with numpy's global generator
(``np.random.permutation``), as JAX does. The capacity mode ranks the valid
rows by uniform scores and deals them round-robin into the splits; its
scores come from a ``torch.Generator`` seeded from ``seed`` and the fill
count where JAX folds a ``jax.random`` key (stated difference D42), and the
draw (:meth:`InceptionScore.draw_ranks`) stays apart from the score
(:meth:`InceptionScore.score_from_ranks`).
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.image.fid import _feature_dim_of, _features
from metrics_tpu_torch.image.kid import seeded_generator
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.bucketed_rank import ascending_order, inverse_permutation
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append, reject_valid_kwarg

Tensor = torch.Tensor


class InceptionScore(Metric):
    """IS = exp(E_x KL(p(y|x) || p(y))) over ``splits`` splits: ``(mean, std)``.

    ``feature`` is a callable ``images -> (N, classes) logits`` or an int or
    str, and then ``update`` takes logits. With ``capacity=N`` the logits
    live in one ring and the update is captured on the card.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> rng = np.random.default_rng(0)
        >>> metric = InceptionScore(feature=10, splits=1, device="cpu")
        >>> metric.update(torch.from_numpy(rng.standard_normal((32, 10)).astype(np.float32)))
        >>> mean, std = metric.compute()
        >>> round(float(mean), 4)
        1.4077
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    jittable_update = False
    jittable_compute = False

    def __init__(
        self,
        feature: Union[int, str, Callable] = "logits_unbiased",
        splits: int = 10,
        capacity: Optional[int] = None,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if callable(feature):
            self.extractor = feature
        elif isinstance(feature, (int, str)):
            self.extractor = None  # update() receives logits
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Integer input to argument `splits` expected to be larger than 0")
        self.splits = splits
        self.capacity = capacity
        self.seed = seed
        if capacity is not None:
            dim = _feature_dim_of(feature, "InceptionScore")
            self.add_state("features", default=CatBuffer.zeros(capacity, (dim,), torch.float32), dist_reduce_fx="cat")
            object.__setattr__(self, "jittable_update", True)
            object.__setattr__(self, "jittable_compute", True)
        else:
            self.add_state("features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor, valid: Optional[Tensor] = None) -> None:
        """``valid`` masks rows in the capacity mode."""
        features = _features(self, imgs)
        if self.capacity is not None:
            self.features = cat_append(self.features, features, valid)
            return
        reject_valid_kwarg(valid)
        self.features.append(features)

    def draw_ranks(self) -> Tensor:
        """The capacity mode's shuffle: each valid row's position in a
        uniform random order of the valid rows (invalid rows after them),
        from a generator seeded by ``seed`` and the fill count (one read
        back)."""
        buf = self.features
        gen = seeded_generator(self.device, self.seed, int(buf.count()))
        scores = torch.rand((buf.capacity,), generator=gen, device=self.device)
        scores = torch.where(buf.mask, scores, float("inf"))
        return inverse_permutation(ascending_order(scores))

    def score_from_ranks(self, rank: Tensor) -> Tuple[Tensor, Tensor]:
        """IS mean and std with the valid rows dealt into the splits by
        ``rank % splits``, each split's marginal its mean; empty splits (fewer
        valid rows than splits) are left out, and an empty ring scores NaN."""
        buf = self.features
        mask = buf.mask
        rank = torch.as_tensor(rank, device=self.device).to(torch.int64)
        split_id = torch.where(mask, rank % self.splits, self.splits)
        prob = torch.softmax(buf.data, dim=1)
        log_prob = torch.log_softmax(buf.data, dim=1)
        w = mask.to(torch.float32)
        segments = self.splits + 1
        seg_prob = torch.zeros((segments, prob.shape[1]), device=self.device).index_add_(0, split_id, prob * w[:, None])
        seg_count = torch.zeros((segments,), device=self.device).index_add_(0, split_id, w)
        counts = seg_count[: self.splits]
        mean_prob = seg_prob[: self.splits] / torch.clamp(counts, min=1.0)[:, None]
        row_kl = (prob * (log_prob - torch.log(mean_prob)[split_id.clamp(0, self.splits - 1)])).sum(dim=1)
        seg_kl = torch.zeros((segments,), device=self.device).index_add_(0, split_id, row_kl * w)
        kl_arr = torch.exp(seg_kl[: self.splits] / torch.clamp(counts, min=1.0))
        nonempty = (counts > 0).to(torch.float32)
        n_used = torch.clamp(nonempty.sum(), min=1.0)
        mean = (kl_arr * nonempty).sum() / n_used
        var = ((kl_arr - mean) ** 2 * nonempty).sum() / torch.clamp(n_used - 1.0, min=1.0)
        std = torch.where(n_used > 1, torch.sqrt(var), float("nan"))
        mean = torch.where(nonempty.sum() > 0, mean, float("nan"))
        return mean, std

    def compute(self) -> Tuple[Tensor, Tensor]:
        if self.capacity is not None:
            return self.score_from_ranks(self.draw_ranks())
        features = dim_zero_cat(self.features)
        idx = torch.from_numpy(np.random.permutation(features.shape[0])).to(features.device)
        features = features[idx]
        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)
        kl_ = []
        for p, log_p in zip(prob.tensor_split(self.splits), log_prob.tensor_split(self.splits)):
            mean_prob = p.mean(dim=0, keepdim=True)
            kl = p * (log_p - torch.log(mean_prob))
            kl_.append(torch.exp(kl.sum(dim=1).mean()))
        kl_arr = torch.stack(kl_)
        return kl_arr.mean(), kl_arr.std()
