"""On the card, at each cell's own size: the lower-precision control (the
reference on scores rounded to bfloat16, put in the program's place) must
fail at least one of the cell's numbers on three seeds. Run on a machine
with a card::

    python3 -m pytest benchmark/tests/test_bench_card.py -m card -s

Each reading is printed as a JSON line. Without a card the tests skip."""
import json

import pytest

from bench_helpers import ROOT, WORKLOADS, need_card
from benchmark.harness import inputs as inputs_mod
from benchmark.harness import judge, program, spec

CONTROL_SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_at_the_cells_size(workload):
    need_card()
    import torch

    cell = spec.load_cell(workload, ROOT)
    members = program.member_specs(cell.config, cell.traffic)
    ref = cell.reference()
    for seed in CONTROL_SEEDS:
        data = inputs_mod.make_inputs(cell.config, cell.traffic, seed, "cuda")
        got = judge.gaps(ref.expected(data, members), ref.expected(data, members, control=True))
        print(json.dumps({"control": workload, "seed": seed, "gaps": got, "limits": cell.limits}))
        assert any(v > cell.limits[k] for k, v in got.items()), got
        del data
        torch.cuda.empty_cache()
