"""``LearnedPerceptualImagePatchSimilarity`` (counterpart of ``metrics_tpu/image/lpip.py``).

The distance is :class:`metrics_tpu_torch.nets.LPIPSNet` (AlexNet or VGG16
with the lpips heads; a seeded random init unless ``weights=`` are given)
or an injected callable ``(img1, img2) -> (N,)``. It is differentiable
through autograd with respect to the images.
"""
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor

# the weightless nets, one per (net_type, device): they are deterministic,
# so metric instances share them rather than build them again
_DEFAULT_NETS: Dict[Tuple[str, str], Callable] = {}


def _default_lpips_net(net_type: str, device: torch.device) -> Callable:
    key = (net_type, str(device))
    if key not in _DEFAULT_NETS:
        from metrics_tpu_torch.nets import LPIPSNet

        _DEFAULT_NETS[key] = LPIPSNet(net_type=net_type, device=device)
    return _DEFAULT_NETS[key]


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS: the mean (or sum) of the per-pair distances.

    Example:
        >>> import warnings
        >>> import torch
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore")
        ...     lpips = LearnedPerceptualImagePatchSimilarity(net_type="alex", device="cpu")
        >>> imgs = torch.zeros((2, 3, 64, 64))
        >>> lpips.update(imgs, imgs)
        >>> float(lpips.compute())
        0.0
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    jittable_update = False
    jittable_compute = False

    def __init__(
        self,
        net_type: str = "alex",
        net: Optional[Callable] = None,
        weights: Any = None,
        reduction: str = "mean",
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if net is None:
            valid_net_type = ("alex", "vgg")
            if net_type not in valid_net_type:
                raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
            if weights is None:
                net = _default_lpips_net(net_type, self.device)
            else:
                from metrics_tpu_torch.nets import LPIPSNet

                net = LPIPSNet(net_type=net_type, weights=weights, device=self.device)
        elif not callable(net):
            raise ValueError(
                "Argument `net` must be a callable `(img1, img2) -> distances` or None for the"
                " AlexNet/VGG LPIPS stack."
            )
        self.net = net
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.normalize = normalize
        self.add_state("sum_scores", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        if self.normalize:
            # [0, 1] -> [-1, 1], the range the perceptual nets expect
            img1 = 2 * img1 - 1
            img2 = 2 * img2 - 1
        loss = torch.as_tensor(self.net(img1, img2)).squeeze()
        self.sum_scores = self.sum_scores + loss.sum()
        self.total += float(img1.shape[0])

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
