"""The yardstick of the kernels' roofline shares: the card's peaks, the
bytes that an update's work needs, counted from its inputs whatever
implements it, and that work summed over the traced updates.

Counting rule (each kernel's file under ``benchmark/kernels/`` applies it):

- each input that the kernel's step needs is counted once, at the width at
  which the user hands it (scores as float32, labels and cohort ids as their
  own dtype: class ids, not a one-hot matrix);
- where the kernel is handed something that the update derives (K2's bin
  ids), it is counted at the narrowest whole-byte width that holds its
  values, since no implementation of that step reads less;
- the state cells that the batch changes are counted once each, 4 bytes a
  count, and only those the data reaches;
- no intermediate (a one-hot matrix, per-row deltas, a histogram scratch)
  and no second read counts.

A member states the work it hands to a kernel in its configuration
(``"kernels": {"k1": {"thresholds": 100}}``); the work is credited per
update, so a design that splits an update's work over more launches does
not raise the share. So a later design that reads ids where today's reads a
one-hot matrix, or counts straight into the rings, moves fewer bytes than
today's and still not fewer than these counts: no share can pass 100 %.
"""
import pathlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from benchmark.harness.spec import BENCH_DIR, load_module

Tensor = torch.Tensor

# published peaks (NVIDIA H100 data sheet, dense rates), by a part of the
# name that torch.cuda.get_device_name() gives
PEAKS: List[Tuple[str, Dict[str, float]]] = [
    ("H100 80GB HBM3", {"hbm_bytes_per_s": 3.35e12}),
    ("H100 NVL", {"hbm_bytes_per_s": 3.9e12}),
    ("H100 PCIe", {"hbm_bytes_per_s": 2.0e12}),
]

# distinct cells are counted with a histogram up to this many keys, above it with a sort
HIST_KEYS = 1 << 27


def peak(device_name: str) -> Optional[Dict[str, float]]:
    for part, values in PEAKS:
        if part in device_name:
            return values
    return None


def kernels(bench_dir: pathlib.Path = BENCH_DIR) -> Dict[str, Any]:
    """``{key: module}`` of every file under ``benchmark/kernels/``."""
    return {p.stem: load_module(p, f"bench_kernel_{p.stem}") for p in sorted((bench_dir / "kernels").glob("*.py"))
            if not p.stem.startswith("_")}


def kernel_of(name: str, names: Dict[str, Tuple[str, ...]]) -> Optional[str]:
    """The key of the port's kernel whose ``NAMES`` a part of ``name`` (a
    kernel's name on the card) is, else None."""
    for key, parts in names.items():
        if any(p in name for p in parts):
            return key
    return None


def id_width(values: int) -> int:
    """Bytes of the narrowest whole-byte integer that holds ``values`` ids."""
    return 1 if values <= 1 << 8 else 2 if values <= 1 << 16 else 4 if values <= 1 << 32 else 8


def distinct(keys: Tensor, key_space: int) -> int:
    if key_space <= HIST_KEYS:
        return int((torch.bincount(keys, minlength=key_space) > 0).sum())
    return int(torch.unique(keys).numel())


def nbytes(t: Optional[Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def batch_work(inputs: Any, members: Dict[str, Dict[str, Any]], modules: Dict[str, Any]) -> Dict[str, List[int]]:
    """``{kernel: [bytes of the i-th update of an epoch]}``, summed over the
    members that state work for that kernel."""
    out: Dict[str, List[int]] = {}
    for spec in members.values():
        for key, params in spec["kernels"].items():
            per = out.setdefault(key, [0] * len(inputs.batches))
            for i in range(len(inputs.batches)):
                args, kwargs = inputs.batch(i)
                per[i] += int(modules[key].work_bytes(args, kwargs, **params))
    return out


def traced_work(per_batch: Dict[str, List[int]], segments: List[Dict[str, Any]]) -> Dict[str, float]:
    """``{kernel: bytes}`` of the updates inside the profiled segments: a
    segment holds the updates from its ``first_batch`` on, one ``update``
    range each."""
    out: Dict[str, float] = {}
    for seg in segments:
        first = int(seg["first_batch"])
        count = sum(1 for r in seg["ranges"] if r[0] == "update")
        for key, per in per_batch.items():
            out[key] = out.get(key, 0.0) + float(sum(per[first:first + count]))
    return out


def share(work_bytes: Optional[float], kernel_s: Optional[float], device_name: str) -> Optional[float]:
    """The time that ``work_bytes`` needs at the card's memory rate over
    ``kernel_s``, the kernel's measured time for that work, in %; None where
    either is missing."""
    rate = peak(device_name)
    if not work_bytes or not kernel_s or not rate:
        return None
    return 100.0 * work_bytes / rate["hbm_bytes_per_s"] / kernel_s
