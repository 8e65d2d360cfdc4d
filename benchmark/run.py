#!/usr/bin/env python3
"""Run one cell of the benchmark of ``metrics_tpu_torch`` on the card.

From the root of a checkout::

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

One fresh process a run: it finds the card (and fails without one), makes the
cell's inputs on the card from ``--seed``, builds the port's collection,
runs one untimed epoch (kernels built on a checkout's first run and loaded,
every shape met), then runs whole epochs for ``--seconds`` and measures them.
After the window it frees the program's state, works the values out again
with the configuration's plain reference and compares every epoch's
``compute()`` with them. It prints one JSON line last on standard output,
and the numbers compared, each beside its limit, as the last lines of
standard error. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a traced run of the same
loop.

Exit codes: 0 with a result (``correct`` true or false); 2 without a card
(or with fewer cards than the cell asks for); 3 when JAX or the JAX package
is loaded once the window has closed; another code on any other failure.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402


def _number(x: Any) -> Any:
    """A JSON number: an infinite gap as the largest float, a missing limit as -1."""
    if isinstance(x, float) and not math.isfinite(x):
        return -1.0 if math.isnan(x) else math.copysign(sys.float_info.max, x)
    return x


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: Any,
             t_start: float) -> Tuple[Dict[str, Any], List[str], Dict[str, Any]]:
    """One run of ``cell`` on ``device``: ``(result, check lines, record)``,
    the record being what the metrics' readers read. The caller has made
    sure the device is the one the cell asks for."""
    import torch

    from benchmark.harness import inputs as inputs_mod
    from benchmark.harness import judge, program, profiling, roofline
    from benchmark.harness.loop import Loop

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    members = program.member_specs(cell.config, cell.traffic)
    data = inputs_mod.make_inputs(cell.config, cell.traffic, seed, dev, cell.bench_dir)
    loop = Loop(program.build_collection(members, dev), data, dev, trace)
    loop.warm(seconds)
    setup_s = time.perf_counter() - t_start

    win = loop.window(seconds)

    # the card's peak as the process held it (the allocator's reserve, CUDA
    # graphs' pools included), and the peak that tensors took of it
    reserved_bytes = int(torch.cuda.max_memory_reserved(dev)) if cuda else 0
    allocated_bytes = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    loop.collection = None  # the program's state goes before the reference runs
    del loop
    gc.unfreeze()  # set-up's objects, the collection among them, were frozen before the window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    record: Dict[str, Any] = {
        "setup_s": setup_s, "window_s": win.seconds, "rows": win.rows, "epochs": win.epochs,
        "update_ms": win.update_ms, "compute_s": win.compute_s, "device_name": device_name,
        "host_update_s": win.host_update_s, "member_updates": win.member_updates, "replays": win.replays,
    }
    if trace:
        kernels = roofline.kernels(cell.bench_dir)
        names = {key: tuple(module.NAMES) for key, module in kernels.items()}
        record["profile"] = profiling.summarize(win.segments, names) if cuda else None
        record["work"] = roofline.traced_work(roofline.batch_work(data, members, kernels), win.segments)

    reference = cell.reference()
    expected = reference.expected(data, members)
    observed = [reference.observed(values, members) for values in win.values]
    correct, failed, checks = judge.judge(expected, observed, cell.limits)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.readers[m["name"]](record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info: Dict[str, Any] = {"platform": "gpu" if cuda else "cpu", "kind": device_name, "count": cell.chips,
                                "memory_peak_bytes": reserved_bytes, "memory_allocated_peak_bytes": allocated_bytes}
    result: Dict[str, Any] = {"correct": correct, "attempted": win.epochs, "failed": failed, "metrics": metrics, "device": dev_info}
    if trace and record["profile"]:
        dev_info["busy_s"] = record["profile"]["busy_s"]
        dev_info["window_s"] = record["profile"]["window_s"]
        dev_info["power_limit"] = _power_limit() if cuda else None
        result["breakdown"] = {"device_ops": record["profile"]["device_ops"], "idle_gaps": record["profile"]["idle_gaps"]}
    result["checks"] = {k: {"value": _number(v["value"]), "limit": _number(v["limit"])} for k, v in checks.items()}
    return result, judge.check_lines(checks), record


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.load_cell(args.workload, ROOT)
    # load from one process with few threads: the loop runs on one host
    # thread, and pools of CPU workers only take the host's time from it
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {count}", file=sys.stderr)
        return 2
    result, lines, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    from benchmark.harness.program import forbidden_loaded

    loaded = forbidden_loaded(list(sys.modules))
    if loaded:
        print(f"benchmark: the process holds {loaded} once the window has closed", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
