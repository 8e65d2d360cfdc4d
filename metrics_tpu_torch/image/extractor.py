"""The bundled image encoder (counterpart of ``metrics_tpu/image/extractor.py``).

:class:`TinyImageEncoder` is a small strided CNN with fixed seeded weights:
a ``feature=`` callable for FID, KID and IS and the backbone of
:func:`perceptual_distance` (an LPIPS-style distance), for relative
comparisons where no pretrained net is at hand. JAX draws its weights with
``jax.random``, which torch cannot reproduce: the port's seeded He init is
its own, and :meth:`TinyImageEncoder.load_jax_params` carries JAX's
weights over for parity.
"""
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utilities.compute import full_float32

Tensor = torch.Tensor

__all__ = ["TinyImageEncoder", "perceptual_distance"]


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one dimension: the extra pixel goes
    after, not before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class TinyImageEncoder:
    """Fixed random-weight CNN ``(N, C, H, W) -> (N, D)``: stride-2 3x3
    convolutions with ReLU, a spatial mean and a linear head.

    Weights depend only on ``seed``; they live on ``device`` (CUDA unless
    the caller asks for the CPU). Images map to ``[-1, 1]`` by
    ``2 * x / data_range - 1``.

    Example:
        >>> import torch
        >>> encoder = TinyImageEncoder(feature_dim=16, device="cpu")
        >>> imgs = torch.randint(0, 256, (4, 3, 32, 32), dtype=torch.uint8)
        >>> tuple(encoder(imgs).shape)
        (4, 16)
    """

    def __init__(
        self,
        feature_dim: int = 192,
        in_channels: int = 3,
        widths: Sequence[int] = (32, 64, 128),
        seed: int = 0,
        data_range: float = 255.0,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params: List[Tensor] = []
        cin = in_channels
        for w in widths:
            fan_in = cin * 9
            params.append(torch.randn((w, cin, 3, 3), generator=gen) * (2.0 / fan_in) ** 0.5)
            cin = w
        head = torch.randn((cin, feature_dim), generator=gen) * (1.0 / cin) ** 0.5
        self.params: Tuple[Tensor, ...] = tuple(p.to(self.device) for p in params)
        self.head = head.to(self.device)
        self.feature_dim = feature_dim
        self.in_channels = in_channels
        self.data_range = float(data_range)

    def load_jax_params(self, params: Sequence[Any], head: Any) -> "TinyImageEncoder":
        """Take the JAX encoder's weights (its ``params``, OIHW conv weights,
        and its ``(C, D)`` ``head``, as numpy arrays); returns self."""
        if len(params) != len(self.params):
            raise ValueError(f"Expected {len(self.params)} conv weights, got {len(params)}")
        new = []
        for mine, theirs in zip(self.params, params):
            arr = np.asarray(theirs, np.float32)
            if arr.shape != tuple(mine.shape):
                raise ValueError(f"Shape mismatch: JAX conv weight {arr.shape} vs {tuple(mine.shape)}")
            new.append(torch.from_numpy(arr.copy()).to(self.device))
        head = np.asarray(head, np.float32)
        if head.shape != tuple(self.head.shape):
            raise ValueError(f"Shape mismatch: JAX head {head.shape} vs {tuple(self.head.shape)}")
        self.params = tuple(new)
        self.head = torch.from_numpy(head.copy()).to(self.device)
        return self

    def _check(self, imgs: Any) -> Tensor:
        imgs = torch.as_tensor(imgs, device=self.device)
        if imgs.ndim != 4 or imgs.shape[1] != self.in_channels:
            raise ValueError(f"Expected images of shape (N, {self.in_channels}, H, W), got {tuple(imgs.shape)}")
        return imgs

    def feature_maps(self, imgs: Any) -> Tuple[Tensor, ...]:
        """Each stage's activation maps, for perceptual distances."""
        x = 2.0 * self._check(imgs).to(torch.float32) / self.data_range - 1.0
        maps = []
        with full_float32(x.is_cuda):
            for w in self.params:
                (top, bottom), (left, right) = (_same_pads(s, 3, 2) for s in x.shape[2:])
                x = torch.relu(F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=2))
                maps.append(x)
        return tuple(maps)

    def __call__(self, imgs: Any) -> Tensor:
        pooled = self.feature_maps(imgs)[-1].mean(dim=(2, 3))
        with full_float32(pooled.is_cuda):
            return pooled @ self.head


def perceptual_distance(encoder: TinyImageEncoder) -> Callable[[Tensor, Tensor], Tensor]:
    """An LPIPS-style distance ``(img1, img2) -> (N,)`` over the encoder's
    stages: unit-normalised activations across channels, squared
    difference, spatial mean, summed over the stages (uniform weights)."""

    def dist(img1: Tensor, img2: Tensor) -> Tensor:
        total = None
        for f1, f2 in zip(encoder.feature_maps(img1), encoder.feature_maps(img2)):
            n1 = f1 / (torch.linalg.vector_norm(f1, dim=1, keepdim=True) + 1e-10)
            n2 = f2 / (torch.linalg.vector_norm(f2, dim=1, keepdim=True) + 1e-10)
            layer = ((n1 - n2) ** 2).sum(dim=1).mean(dim=(1, 2))
            total = layer if total is None else total + layer
        return total

    return dist
