"""The cell's inputs, made on the card from ``--seed``.

Generators are files found by name: the configuration's ``data`` block names
its ``kind``, ``benchmark/data/<kind>.py``, whose ``make_rows(config,
generator, device)`` returns the positional inputs of ``update()`` (each
indexed by row) and the rows in one item (an image, a tile); a traffic's
``row_inputs`` names each keyword input of ``update()`` (such as
``slice_ids``) with a ``kind`` whose file's ``make_column(params, rows,
generator, device)`` returns one value a row. The traffic's ``batch_items``
cuts the rows into an epoch's batches. Every seed gives the same sizes; the
seed changes only which values and which rows.
"""
import pathlib
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from benchmark.harness.spec import BENCH_DIR, load_module

Tensor = torch.Tensor


@dataclass
class Inputs:
    """What the harness hands to the program and to the reference alike."""

    args: Tuple[Tensor, ...]  # update()'s positional inputs, indexed by row: (preds, target)
    kwargs: Dict[str, Tensor]  # update()'s keyword inputs, indexed by row: {"slice_ids": ids}
    batches: List[Tuple[int, int]]  # [start, stop) row ranges of one epoch

    @property
    def rows(self) -> int:
        return int(self.args[0].shape[0])

    def batch(self, i: int) -> Tuple[Tuple[Tensor, ...], Dict[str, Tensor]]:
        """The arguments of the ``i``-th ``update`` of an epoch (views)."""
        lo, hi = self.batches[i]
        return tuple(a[lo:hi] for a in self.args), {k: v[lo:hi] for k, v in self.kwargs.items()}


def generator(kind: str, bench_dir: pathlib.Path = BENCH_DIR) -> Any:
    return load_module(bench_dir / "data" / f"{kind}.py", f"bench_data_{kind}")


def make_inputs(config: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: Any,
                bench_dir: pathlib.Path = BENCH_DIR) -> Inputs:
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    args, item_rows = generator(config["data"]["kind"], bench_dir).make_rows(config, g, device)
    rows = int(args[0].shape[0])
    kwargs = {name: generator(params["kind"], bench_dir).make_column(params, rows, g, device)
              for name, params in traffic.get("row_inputs", {}).items()}
    step = int(traffic["batch_items"]) * int(item_rows)
    return Inputs(args=tuple(args), kwargs=kwargs, batches=[(lo, min(rows, lo + step)) for lo in range(0, rows, step)])
