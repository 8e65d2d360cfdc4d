"""``zipf_ids``: a column of int64 ids in ``[0, count)`` (cohorts, tenants)
whose group sizes fall as ``rank ** -zipf_exponent``. The sizes are the same
for every seed (largest remainders); a seeded permutation deals them to the
rows, so every id lies in range."""
from typing import Any, Dict, List

import torch


def sizes(rows: int, count: int, exponent: float) -> List[int]:
    """Sizes falling as ``rank ** -exponent`` that sum to ``rows``: each
    group its floor, then one more row to the largest remainders."""
    weights = [(k + 1) ** -exponent for k in range(count)]
    total = sum(weights)
    exact = [rows * w / total for w in weights]
    out = [int(x) for x in exact]
    for k in sorted(range(count), key=lambda k: exact[k] - out[k], reverse=True)[: rows - sum(out)]:
        out[k] += 1
    return out


def make_column(params: Dict[str, Any], rows: int, g: torch.Generator, device: torch.device) -> torch.Tensor:
    count = int(params["count"])
    counts = torch.tensor(sizes(rows, count, float(params["zipf_exponent"])), device=device)
    ids = torch.repeat_interleave(torch.arange(count, device=device, dtype=torch.int64), counts)
    return ids[torch.randperm(rows, generator=g, device=device)]
