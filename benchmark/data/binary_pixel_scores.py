"""``binary_pixel_scores``: ``tiles`` masks of ``tile_side`` x ``tile_side``
pixels, flattened. A pixel is foreground with probability
``foreground_share``; a foreground score is uniform on ``[foreground_low,
1)``; a background score is, with probability ``background_floor_share``,
uniform on ``[0, background_floor_high)`` (the lowest bin) and otherwise
``u ** background_power`` for a uniform ``u``. Scores are float32, masks
uint8 0/1 as 8-bit mask images decode. One item is one tile."""
from typing import Any, Dict, Tuple

import torch

# rows made at once: four uniform draws of 2^26 rows, 1 GiB
CHUNK = 1 << 26


def make_rows(config: Dict[str, Any], g: torch.Generator, device: torch.device) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """``((scores, masks), pixels a tile)``."""
    side = int(config["tile_side"])
    n = int(config["tiles"]) * side * side
    data = config["data"]
    scores = torch.empty((n,), dtype=torch.float32, device=device)
    masks = torch.empty((n,), dtype=torch.uint8, device=device)
    fg_low = float(data["foreground_low"])
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        u = torch.rand((4, hi - lo), generator=g, device=device)
        fg = u[0] < float(data["foreground_share"])
        floor = u[1] < float(data["background_floor_share"])
        background = torch.where(floor, u[2] * float(data["background_floor_high"]), u[2].pow(float(data["background_power"])))
        scores[lo:hi] = torch.where(fg, fg_low + (1.0 - fg_low) * u[3], background)
        masks[lo:hi] = fg.to(torch.uint8)
        del u, fg, floor, background
    return (scores, masks), side * side
