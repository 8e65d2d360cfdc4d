"""LPIPS: the AlexNet and VGG16 feature stacks with learned linear heads
(counterpart of ``metrics_tpu/nets/lpips_net.py``).

The backbone is torchvision's ``features`` ``Sequential`` with its indices,
so a torchvision ``alexnet``/``vgg16`` state dict's ``features.<N>.*`` keys
load as they are; the ``lpips`` package's ``net.slice<K>.<N>.*`` aliases
and its ``lin<K>.model.1.weight`` / ``lins.<K>.model.1.weight`` heads
(``(1, C, 1, 1)``; the JAX package's heads are ``(C,)`` vectors, as the
port's) load through :func:`load_lpips_torch_state_dict`. The distance is
the LPIPS recipe: the input scaling layer, channel-unit-normalised taps,
squared differences weighted by the heads, a spatial mean, summed over the
five taps. Without checkpoints the net is a seeded random init and warns;
:func:`load_jax_variables` carries the JAX package's variables over.
"""
from typing import Any, Dict, Mapping, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.nets._loading import as_state_dict, conv_weight, flax_leaves, load_strict, seeded_init
from metrics_tpu_torch.utilities.compute import full_float32
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

__all__ = ["AlexNetFeatures", "VGG16Features", "LPIPSNet", "load_lpips_torch_state_dict", "load_jax_variables"]

# (torchvision features index, out_channels, kernel, stride, padding, tap after its ReLU)
_ALEX_CONVS = (
    (0, 64, 11, 4, 2, True),
    (3, 192, 5, 1, 2, True),
    (6, 384, 3, 1, 1, True),
    (8, 256, 3, 1, 1, True),
    (10, 256, 3, 1, 1, True),
)
_ALEX_POOL_BEFORE = (3, 6)  # max pool (3, stride 2) at index - 1
_VGG_CONVS = (
    (0, 64, 3, 1, 1, False),
    (2, 64, 3, 1, 1, True),
    (5, 128, 3, 1, 1, False),
    (7, 128, 3, 1, 1, True),
    (10, 256, 3, 1, 1, False),
    (12, 256, 3, 1, 1, False),
    (14, 256, 3, 1, 1, True),
    (17, 512, 3, 1, 1, False),
    (19, 512, 3, 1, 1, False),
    (21, 512, 3, 1, 1, True),
    (24, 512, 3, 1, 1, False),
    (26, 512, 3, 1, 1, False),
    (28, 512, 3, 1, 1, True),
)
_VGG_POOL_BEFORE = (5, 10, 17, 24)  # max pool (2, stride 2) at index - 1

#: per-tap channel widths (the lpips package's ``chns``)
LPIPS_CHANNELS = {"alex": (64, 192, 384, 256, 256), "vgg": (64, 128, 256, 512, 512)}

# the lpips scaling layer: ImageNet mean and std for [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _TorchvisionFeatures(nn.Module):
    """A torchvision ``features`` stack up to its last tap, returning the
    activations after each tapped ReLU."""

    def __init__(self, convs: tuple, pool_before: tuple, pool_window: int) -> None:
        super().__init__()
        layers = []
        self.tap_after = []
        cin = 3
        for idx, cout, k, s, p, tap in convs:
            if idx in pool_before:
                layers.append(nn.MaxPool2d(pool_window, stride=2))
            layers += [nn.Conv2d(cin, cout, k, stride=s, padding=p), nn.ReLU()]
            if tap:
                self.tap_after.append(idx + 1)
            cin = cout
        self.features = nn.Sequential(*layers)

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.tap_after:
                taps.append(x)
        return tuple(taps)


class AlexNetFeatures(_TorchvisionFeatures):
    """torchvision AlexNet ``features``, returning the five LPIPS taps."""

    def __init__(self) -> None:
        super().__init__(_ALEX_CONVS, _ALEX_POOL_BEFORE, 3)


class VGG16Features(_TorchvisionFeatures):
    """torchvision VGG16 ``features``, returning relu{1_2,2_2,3_3,4_3,5_3}."""

    def __init__(self) -> None:
        super().__init__(_VGG_CONVS, _VGG_POOL_BEFORE, 2)


class _LPIPSModule(nn.Module):
    """Scaling layer, backbone taps, normalised squared differences, lin
    heads, spatial mean, sum over the taps."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        self.net = {"alex": AlexNetFeatures, "vgg": VGG16Features}[net_type]()
        for k, c in enumerate(LPIPS_CHANNELS[net_type]):
            self.register_parameter(f"lin{k}", nn.Parameter(torch.empty(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, img0: Tensor, img1: Tensor) -> Tensor:
        n = img0.shape[0]
        x = (torch.cat([img0, img1]).to(torch.float32) - self.shift) / self.scale
        total = torch.zeros((), device=x.device)
        for k, f in enumerate(self.net(x)):
            f = f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10)
            diff = (f[:n] - f[n:]) ** 2
            lin = getattr(self, f"lin{k}")
            total = total + (diff * lin[None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
        return total


def _lpips_key(key: str) -> Union[str, None]:
    """A checkpoint key as the port's, or None for keys it skips."""
    parts = key.split(".")
    if parts[0] == "classifier" or key.endswith("num_batches_tracked"):
        return None
    if parts[0].startswith("net") and len(parts) >= 2 and parts[1].startswith("slice"):
        parts = ["features", *parts[2:]]  # net.sliceK.N.* -> features.N.*
    if parts[0] == "features":
        return "net." + ".".join(parts)
    if parts[0] == "lins":
        return f"lin{parts[1]}"
    if parts[0].startswith("lin"):
        return parts[0]
    if parts[0] == "scaling_layer" or parts[-1] in ("shift", "scale"):
        return None  # the scaling constants are the module's own
    raise KeyError(f"Unrecognized LPIPS checkpoint key: {key}")


def load_lpips_torch_state_dict(module: nn.Module, path_or_dict: Any) -> nn.Module:
    """Load torch weights into an LPIPS module (or an :class:`LPIPSNet`'s),
    in place; returns the module. Takes torchvision backbones
    (``features.<N>.*``, ``classifier.*`` skipped) and ``lpips`` package
    models (``net.slice<K>.<N>.*``, ``lin<K>.model.1.weight``,
    ``lins.<K>.model.1.weight``), alone or layered by repeated calls."""
    net = getattr(module, "module", module)
    values: Dict[str, Tensor] = {}
    for key, value in as_state_dict(path_or_dict).items():
        name = _lpips_key(key)
        if name is not None:
            values[name] = value.reshape(-1) if name.startswith("lin") else value
    load_strict(net, values, "LPIPS checkpoint")
    return module


def load_jax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load the JAX package's LPIPS variables (``{"params": {"net":
    {"conv<N>": {"kernel", "bias"}}, "lin<K>": ...}}``) into an LPIPS module
    (or an :class:`LPIPSNet`'s), in place; returns the module."""
    net = getattr(module, "module", module)
    values = {}
    for path, arr in flax_leaves(variables.get("params", {})):
        if len(path) == 3 and path[0] == "net" and path[1].startswith("conv"):
            idx = path[1][len("conv"):]
            if path[2] == "kernel":
                values[f"net.features.{idx}.weight"] = conv_weight(arr)
            elif path[2] == "bias":
                values[f"net.features.{idx}.bias"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"Unrecognized LPIPS variable params/{'/'.join(path)}")
        elif len(path) == 1 and path[0].startswith("lin"):
            values[path[0]] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"Unrecognized LPIPS variable params/{'/'.join(path)}")
    load_strict(net, values, "LPIPS JAX variable")
    return module


class LPIPSNet:
    """The LPIPS distance ``(img0, img1) -> (N,)`` on NCHW floats in
    ``[-1, 1]``: the ``net=`` of
    :class:`~metrics_tpu_torch.image.lpip.LearnedPerceptualImagePatchSimilarity`.
    Differentiable with respect to the images (the weights are fixed).

    Args:
        net_type: ``"alex"`` (the lpips default) or ``"vgg"``.
        weights: checkpoint(s) for :func:`load_lpips_torch_state_dict`, one
            or a sequence layered in order (a torchvision backbone, then the
            lpips heads).
        seed: the seed of the random init (heads uniform in ``[0, 1)``).
        device: where the net runs (CUDA unless the caller asks for the CPU).
    """

    def __init__(
        self,
        net_type: str = "alex",
        weights: Any = None,
        seed: int = 0,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        if net_type not in ("alex", "vgg"):
            raise ValueError(f"Argument `net_type` must be 'alex' or 'vgg', got {net_type!r}")
        self.net_type = net_type
        self.seed = seed
        self.device = resolve_device(device)
        self.module = _LPIPSModule(net_type)
        seeded_init(self.module, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for k in range(len(LPIPS_CHANNELS[net_type])):
                lin = getattr(self.module, f"lin{k}")
                lin.copy_(torch.rand(lin.shape, generator=gen))
        self.module.eval().requires_grad_(False).to(self.device)
        self.calibrated = weights is not None
        if weights is not None:
            for ckpt in weights if isinstance(weights, (list, tuple)) else [weights]:
                load_lpips_torch_state_dict(self.module, ckpt)
        else:
            rank_zero_warn(
                f"LPIPSNet('{net_type}') constructed without pretrained weights: the architecture "
                "is the real LPIPS stack but backbone and lin heads are random init, so distances "
                "are NOT comparable to published LPIPS values. Pass `weights=` (torchvision "
                "backbone and/or lpips lin checkpoints) for calibrated numbers.",
                UserWarning,
            )

    def __call__(self, img0: Any, img1: Any) -> Tensor:
        img0 = torch.as_tensor(img0, device=self.device)
        img1 = torch.as_tensor(img1, device=self.device)
        if img0.ndim != 4 or img0.shape[1] != 3:
            raise ValueError(f"Expected images of shape (N, 3, H, W), got {tuple(img0.shape)}")
        with full_float32(img0.is_cuda):
            return self.module(img0, img1)

    def load_torch_state_dict(self, path_or_dict: Any) -> "LPIPSNet":
        load_lpips_torch_state_dict(self.module, path_or_dict)
        self.calibrated = True
        return self
