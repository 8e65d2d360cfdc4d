"""Image gradients (counterpart of ``metrics_tpu/functional/image/gradients.py``)."""
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _image_gradients_validate(img: Tensor) -> None:
    if not isinstance(img, Tensor):
        raise TypeError(f"The `img` expects an array type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    dy = F.pad(img[..., 1:, :] - img[..., :-1, :], (0, 0, 0, 1))
    dx = F.pad(img[..., :, 1:] - img[..., :, :-1], (0, 1, 0, 0))
    return dy, dx


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """1-step finite-difference gradients ``(dy, dx)``, zero on the last row
    and column.

    Example:
        >>> import torch
        >>> image = torch.arange(0, 1 * 1 * 5 * 5, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :, 0].tolist()
        [5.0, 5.0, 5.0, 5.0, 0.0]
    """
    img = torch.as_tensor(img)
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
