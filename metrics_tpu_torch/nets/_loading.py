"""Shared loading helpers of the nets: a torch checkpoint as a flat state
dict, a flax variables tree as dotted keys, a seeded init, and a strict
load that names the key at fault."""
import math
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor


def as_state_dict(path_or_dict: Any) -> Dict[str, Tensor]:
    """A mapping of tensors or arrays, or the path of a ``torch.save`` file
    (a ``{"state_dict": ...}`` wrapper is unwrapped), as CPU tensors."""
    if isinstance(path_or_dict, (str, bytes)) or hasattr(path_or_dict, "__fspath__"):
        raw = torch.load(path_or_dict, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and isinstance(raw.get("state_dict"), dict):
            raw = raw["state_dict"]
    elif isinstance(path_or_dict, Mapping):
        raw = path_or_dict
    else:
        raise TypeError(f"Expected a state-dict mapping or a checkpoint path, got {type(path_or_dict).__name__}")
    return {str(k): v.detach().cpu() if isinstance(v, Tensor) else torch.from_numpy(np.array(v)) for k, v in raw.items()}


def flax_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """``(path, array)`` for every leaf of a nested dict of arrays."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from flax_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def conv_weight(kernel: np.ndarray) -> Tensor:
    """A flax ``(kH, kW, I, O)`` conv kernel as a torch ``(O, I, kH, kW)`` weight."""
    if kernel.ndim != 4:
        raise ValueError(f"Expected a 4d conv kernel, got shape {kernel.shape}")
    return torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))


def dense_weight(kernel: np.ndarray) -> Tensor:
    """A flax ``(in, out)`` dense kernel as a torch ``(out, in)`` weight."""
    if kernel.ndim != 2:
        raise ValueError(f"Expected a 2d dense kernel, got shape {kernel.shape}")
    return torch.from_numpy(np.ascontiguousarray(kernel.T))


def load_strict(module: nn.Module, values: Mapping[str, Tensor], what: str) -> None:
    """Copy ``values`` into ``module``'s parameters and buffers: an unknown
    key raises ``KeyError``, a shape mismatch ``ValueError``, both naming
    the key; keys left out keep their values."""
    own = module.state_dict()
    for key, value in values.items():
        if key not in own:
            raise KeyError(f"Unrecognized {what} key: {key}")
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"Shape mismatch at {key}: checkpoint {tuple(value.shape)} vs model {tuple(own[key].shape)}")
    with torch.no_grad():
        for key, value in values.items():
            own[key].copy_(value.to(own[key].dtype))


def seeded_init(module: nn.Module, seed: int) -> None:
    """Deterministic weights from ``seed``, drawn on the CPU (the same on
    every device), zero biases, identity batch norms. A convolution over
    ReLU outputs (more than three input channels) has zero-mean filters of
    variance ``2 / (fan_in * (1 - 1/pi))``: its nonnegative input's mean
    then cancels, so no channel is dead at any depth, and the gain keeps the
    variance of a ReLU of a centred input from one layer to the next. The
    first convolution and the dense layers are He-normal."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=gen)
                gain = 2.0
                if isinstance(m, nn.Conv2d) and m.in_channels > 3:
                    w = w - w.mean(dim=(1, 2, 3), keepdim=True)
                    gain = 2.0 / (1.0 - 1.0 / math.pi)
                m.weight.copy_(w * (gain / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
