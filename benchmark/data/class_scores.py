"""``class_scores``: ``rows`` x ``classes`` softmax scores of seeded standard
normal logits with the true class's logit raised by ``signal``, float32, and
int64 class ids drawn uniformly. One item is one row."""
from typing import Any, Dict, Tuple

import torch


def make_rows(config: Dict[str, Any], g: torch.Generator, device: torch.device) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """``((scores, class ids), rows an item)``."""
    n, c = int(config["rows"]), int(config["classes"])
    target = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int64)
    logits = torch.randn((n, c), generator=g, device=device, dtype=torch.float32)
    logits[torch.arange(n, device=device), target] += float(config["data"]["signal"])
    return (torch.softmax(logits, dim=1), target), 1
