"""InceptionV3 for FID, KID and IS (counterpart of ``metrics_tpu/nets/inception_v3.py``).

The graph of torchvision's ``inception_v3`` with the four taps of the
reference (64 / 192 / 768 / 2048) and the logits. Module names are
torchvision's, so a torchvision ``inception_v3`` or pytorch-fid
``pt_inception`` state dict loads as it is
(:func:`load_inception_torch_state_dict`). ``variant="fid"`` applies the
pytorch-fid pools (average pools that leave the padding out of the count in
the A/C/E blocks, a max-pool branch in ``Mixed_7c``) that match the
TF-ported FID weights. Batch norm is inference-only (eps 1e-3). On the card
the convolutions and the products run in full float32 (no TF32).

No pretrained weights ship with the repository, and none can be fetched:
without a checkpoint the net is a seeded random init and warns that its
values are not comparable to published tables. JAX's ``jax.random`` init
cannot be reproduced in torch; :func:`load_jax_variables` carries the JAX
package's variables over for parity.
"""
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.nets._loading import as_state_dict, conv_weight, dense_weight, flax_leaves, load_strict, seeded_init
from metrics_tpu_torch.utilities.compute import full_float32
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

__all__ = ["InceptionV3", "InceptionV3Extractor", "load_inception_torch_state_dict", "load_jax_variables", "VALID_FEATURES"]

#: the feature widths the reference accepts
VALID_FEATURES = (64, 192, 768, 2048)


class BasicConv2d(nn.Module):
    """Conv (no bias) + inference batch norm (eps 1e-3) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, **kwargs: Any) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, bias=False, **kwargs)
        self.bn = nn.BatchNorm2d(out_channels, eps=0.001)

    def forward(self, x: Tensor) -> Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        return torch.relu(x)


def _avg_pool(x: Tensor, count_include_pad: bool) -> Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int, fid_variant: bool = False) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, kernel_size=1)
        self.fid_variant = fid_variant

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, count_include_pad=not self.fid_variant))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int, fid_variant: bool = False) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, kernel_size=1)
        self.fid_variant = fid_variant

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool(x, count_include_pad=not self.fid_variant))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool``: ``"avg"`` (torchvision), ``"avg_nopad"`` (the fid variant's
    ``Mixed_7b``) or ``"max"`` (its ``Mixed_7c``)."""

    def __init__(self, in_channels: int, pool: str = "avg") -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, kernel_size=1)
        self.pool = pool

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool(x, count_include_pad=self.pool == "avg")
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """The InceptionV3 trunk: NCHW float images in ``[-1, 1]`` in, a
    ``{width: features}`` dict of the requested taps out, with
    ``"logits"`` when ``num_classes`` is set and the 2048 tap is reached
    (1000 classes for the stock checkpoints, 1008 for the FID weights)."""

    def __init__(self, variant: str = "fid", num_classes: Optional[int] = 1000) -> None:
        super().__init__()
        if variant not in ("fid", "torchvision"):
            raise ValueError(f"Unknown InceptionV3 variant {variant!r}")
        self.variant = variant
        self.num_classes = num_classes
        fid = variant == "fid"
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg_nopad" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, pool="max" if fid else "avg")
        self.fc = nn.Linear(2048, num_classes) if num_classes else None

    def forward(self, x: Tensor, features: Sequence[int] = (2048,)) -> Dict[Union[int, str], Tensor]:
        for f in features:
            if f not in VALID_FEATURES:
                raise ValueError(f"Feature tap {f} not in {VALID_FEATURES}")
        want = set(features)
        deepest = max(want)
        taps: Dict[Union[int, str], Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        if 64 in want:
            taps[64] = x.mean(dim=(2, 3))
        if deepest == 64:
            return taps
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, stride=2)
        if 192 in want:
            taps[192] = x.mean(dim=(2, 3))
        if deepest == 192:
            return taps
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        if 768 in want:
            taps[768] = x.mean(dim=(2, 3))
        if deepest == 768:
            return taps
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = x.mean(dim=(2, 3))
        if 2048 in want:
            taps[2048] = pooled
        if self.fc is not None:
            taps["logits"] = self.fc(pooled)
        return taps


def load_inception_torch_state_dict(module: nn.Module, path_or_dict: Any) -> nn.Module:
    """Load a torchvision ``inception_v3`` or pytorch-fid ``pt_inception``
    state dict into an :class:`InceptionV3` (or an extractor's), in place;
    returns the module. ``AuxLogits.*`` (the training head) is skipped, and
    ``fc.*`` when the net has no classifier; an unknown key raises
    ``KeyError`` and a shape mismatch ``ValueError``."""
    net = getattr(module, "module", module)
    values = {
        k: v for k, v in as_state_dict(path_or_dict).items()
        if not k.startswith("AuxLogits.") and not (k.startswith("fc.") and net.fc is None)
    }
    load_strict(net, values, "InceptionV3 checkpoint")
    return module


def load_jax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load the JAX package's ``InceptionV3`` variables (``{"params": ...,
    "batch_stats": ...}``, nested dicts of arrays) into an
    :class:`InceptionV3` (or an extractor's), in place; returns the module.
    Conv kernels go HWIO -> OIHW, batch norm ``scale``/``bias``/``mean``/``var``
    to ``weight``/``bias``/``running_mean``/``running_var``, the dense
    kernel is transposed."""
    net = getattr(module, "module", module)
    values = {}
    for collection, tree in variables.items():
        for path, arr in flax_leaves(tree):
            *mod, leaf = path
            prefix = ".".join(mod)
            if collection == "params" and leaf == "kernel" and mod[-1] == "conv":
                values[f"{prefix}.weight"] = conv_weight(arr)
            elif collection == "params" and leaf == "kernel" and mod == ["fc"]:
                values["fc.weight"] = dense_weight(arr)
            elif collection == "params" and leaf in ("scale", "bias"):
                values[f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}"] = torch.from_numpy(arr.copy())
            elif collection == "batch_stats" and leaf in ("mean", "var"):
                values[f"{prefix}.running_{leaf}"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"Unrecognized InceptionV3 variable {collection}/{'/'.join(path)}")
    load_strict(net, values, "InceptionV3 JAX variable")
    return module


class InceptionV3Extractor:
    """The ``images -> (N, D)`` extractor over :class:`InceptionV3` for
    ``FrechetInceptionDistance(feature=...)``, KID and IS: uint8
    ``[0, 255]`` NCHW input, a bilinear resize to 299x299 (antialiased when
    it shrinks, as ``jax.image.resize``), a scale to ``[-1, 1]``, then the
    tap. :meth:`taps` returns several taps of one forward.

    Args:
        feature: tap width, one of ``(64, 192, 768, 2048)``, or
            ``"logits"`` (for InceptionScore).
        weights: a torch state dict or checkpoint path (torchvision or
            pytorch-fid naming); without it the net is a seeded random
            init and warns.
        variant: ``"fid"`` or ``"torchvision"`` pooling.
        resize: resize to 299x299 first.
        seed: the seed of the random init.
        device: where the net runs (CUDA unless the caller asks for the CPU).
    """

    def __init__(
        self,
        feature: Union[int, str] = 2048,
        weights: Any = None,
        variant: str = "fid",
        resize: bool = True,
        seed: int = 0,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        if feature != "logits" and feature not in VALID_FEATURES:
            raise ValueError(f"Integer `feature` must be one of {VALID_FEATURES}, got {feature}")
        self.feature = feature
        self.variant = variant
        self.resize = resize
        self.seed = seed
        self.device = resolve_device(device)
        self.module = InceptionV3(variant=variant, num_classes=1008 if variant == "fid" else 1000)
        seeded_init(self.module, seed)
        self.module.eval().requires_grad_(False).to(self.device)
        self.calibrated = weights is not None
        if weights is not None:
            load_inception_torch_state_dict(self.module, weights)
        else:
            rank_zero_warn(
                "InceptionV3Extractor constructed without pretrained weights: the architecture is "
                "the real FID InceptionV3 but the init is random, so FID/KID/IS values are NOT "
                "comparable to published tables. Pass `weights=` (a torchvision inception_v3 or "
                "pytorch-fid pt_inception state dict / checkpoint path) for calibrated numbers.",
                UserWarning,
            )

    @property
    def feature_dim(self) -> int:
        if self.feature == "logits":
            return self.module.num_classes or 1000
        return int(self.feature)

    def preprocess(self, imgs: Any) -> Tensor:
        """uint8 (or float ``[0, 255]``) NCHW images as the net's input."""
        x = torch.as_tensor(imgs, device=self.device)
        if x.ndim != 4 or x.shape[1] != 3:
            raise ValueError(f"Expected images of shape (N, 3, H, W), got {tuple(x.shape)}")
        x = x.to(torch.float32)
        if self.resize and tuple(x.shape[2:]) != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=True)
        return x / 127.5 - 1.0

    def taps(self, imgs: Any, features: Sequence[int] = (2048,)) -> Dict[Union[int, str], Tensor]:
        """The net's taps of one forward (``"logits"`` comes with 2048)."""
        x = self.preprocess(imgs)
        with full_float32(x.is_cuda):
            return self.module(x, features=features)

    def __call__(self, imgs: Any) -> Tensor:
        if self.feature == "logits":
            return self.taps(imgs, (2048,))["logits"]
        return self.taps(imgs, (self.feature,))[self.feature]

    def load_torch_state_dict(self, path_or_dict: Any) -> "InceptionV3Extractor":
        """Load real torch weights in place; returns self."""
        load_inception_torch_state_dict(self.module, path_or_dict)
        self.calibrated = True
        return self
