"""Shared pieces of the benchmark's tests: a copy of the benchmark at tiny
sizes that runs on the CPU, and a card check made inside a test."""
import json
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
WORKLOADS = ("imagenet1k_cls.val_b1024", "deepglobe_road.val_b16", "imagenet1k_cls.cohorts256_b1024")

# each configuration and traffic mix cut to a size that a test run holds
TINY_CONFIGS = {"imagenet1k_cls": {"rows": 700, "classes": 12}, "deepglobe_road": {"tiles": 9, "tile_side": 32}}
TINY_TRAFFIC = {"val_b1024": {"batch_items": 64}, "val_b16": {"batch_items": 2},
                "cohorts256_b1024": {"batch_items": 64, "row_inputs": {"slice_ids": {"kind": "zipf_ids", "count": 8, "zipf_exponent": 1.0}}}}


def tiny_copy(dest: pathlib.Path) -> pathlib.Path:
    """``BENCHMARK.json`` and ``benchmark/`` copied under ``dest`` with the
    configurations and traffic cut to tiny sizes; returns ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for kind, cuts in (("configs", TINY_CONFIGS), ("traffic", TINY_TRAFFIC)):
        for name, cut in cuts.items():
            path = dest / "benchmark" / kind / f"{name}.json"
            doc = json.loads(path.read_text())
            doc.update(cut)
            path.write_text(json.dumps(doc))
    return dest


def need_card() -> None:
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
