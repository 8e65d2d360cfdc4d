#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line, and any failure exits non-zero:

1. device: the card, and its name and power limit as ``nvidia-smi`` reports them;
2. build: compile every CUDA kernel of the main path from ``metrics_tpu_torch/csrc/``;
3. parity: each kernel against its plain PyTorch version on the card, bit-equal,
   at the main path's shape and at the edges;
4. main path: an ImageNet-1k validation epoch (50,000 rows, 1000 classes,
   1024-row batches) through ``MetricCollection({acc1, acc5, bap})`` on the
   card, checked against the same run of the port on the CPU;
5. profile: where one batch update's time goes (each member alone, and a
   ``torch.profiler`` window: device busy time, top kernels and host calls);
6. kernels: each kernel's time, its bound on this card, and its launches on
   the main path.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, the script prints no result and exits 1.
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

SEED = 0
ROWS = 50_000  # the ILSVRC2012 validation set
CLASSES = 1000
THRESHOLDS = 100  # BinnedAveragePrecision's default
BATCH = 1024
SIGNAL = 4.0  # added to the true class's logit, so accuracy is far above chance
FORWARD_EVERY = 16  # batches 0, 16, 32 and 48 go through forward(), the rest through update()
AP_ATOL = 1e-6  # float32 sums over thresholds, added in another order on the card

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def cuda_time_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from metrics_tpu_torch.ops import _build, binned_counters

    t0 = time.perf_counter()
    _build.load(binned_counters.SOURCE)
    info = _build.build_info.get(binned_counters.SOURCE, {})
    emit({
        "phase": "build",
        "source": f"metrics_tpu_torch/csrc/{binned_counters.SOURCE}",
        "library": str(_build.library_path(binned_counters.SOURCE).relative_to(ROOT)),
        "built_now": bool(info),
        "nvcc_s": info.get("seconds"),
        "seconds": time.perf_counter() - t0,
        "ptxas": info.get("ptxas", []),
    })


def make_data(device):
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    target = torch.randint(0, CLASSES, (ROWS,), generator=g, device=device)
    logits = torch.randn((ROWS, CLASSES), generator=g, device=device)
    logits[torch.arange(ROWS, device=device), target] += SIGNAL
    preds = torch.softmax(logits, dim=1)
    return preds, target


def phase_parity(preds, target):
    """K1 against its plain version on the card, bit for bit."""
    import torch

    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.utilities.data import jax_linspace, to_onehot

    dev = preds.device
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    thr = jax_linspace(0, 1.0, THRESHOLDS, device=dev)
    onehot = to_onehot(target[:BATCH], CLASSES) == 1
    p = preds[:BATCH]

    nasty = p.clone()
    pick = torch.rand(nasty.shape, generator=g, device=dev)
    nasty[pick < 0.1] = float("nan")
    nasty[(pick >= 0.1) & (pick < 0.15)] = float("inf")
    nasty[(pick >= 0.15) & (pick < 0.2)] = float("-inf")
    on_thr = thr[torch.randint(0, THRESHOLDS, (BATCH, CLASSES), generator=g, device=dev)]
    unsorted = torch.cat([torch.rand(30, generator=g, device=dev), thr[torch.tensor([5, 5, 50, 0, 99, 99, 42], device=dev)]])
    small = lambda n, c: (torch.rand((n, c), generator=g, device=dev), torch.rand((n, c), generator=g, device=dev) < 0.3)  # noqa: E731

    cases = [
        ("full", p, onehot, thr),
        ("n0", p[:0], onehot[:0], thr),
        ("n1", p[:1], onehot[:1], thr),
        ("n848", p[:848], onehot[:848], thr),
        ("c1", p[:, :1].contiguous(), onehot[:, :1].contiguous(), thr),
        ("t5", p, onehot, jax_linspace(0, 1.0, 5, device=dev)),
        ("nan_inf", nasty, onehot, thr),
        ("equal_to_thresholds", on_thr, onehot, thr),
        ("unsorted_thresholds", p, onehot, unsorted),
        ("t1000", *small(256, 64), jax_linspace(0, 1.0, 1000, device=dev)),
        ("t5000_two_threshold_tiles", *small(64, 3), torch.rand(5000, generator=g, device=dev)),
    ]
    rows = []
    max_err = 0.0
    for name, pp, tt, th in cases:
        got = k1.binned_counter_update(pp, tt, th)
        want = k1.binned_counter_update_plain(pp, tt, th)
        torch.cuda.synchronize()
        equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(got, want))
        max_err = max(max_err, err)
        rows.append({"case": name, "shape": [pp.shape[0], pp.shape[1], th.shape[0]], "bit_equal": equal, "max_abs_err": err})
        if not equal:
            emit({"phase": "parity", "cases": rows})
            raise AssertionError(f"binned_counters kernel differs from its plain version in case {name!r}")
    full_err = rows[0]["max_abs_err"]
    emit({"phase": "parity", "kernel": "binned_counters", "cases": rows, "max_abs_err": max_err})
    return full_err


def build_collection(pkg, device):
    return pkg.MetricCollection({
        "acc1": pkg.Accuracy(num_classes=CLASSES, device=device),
        "acc5": pkg.Accuracy(num_classes=CLASSES, top_k=5, device=device),
        "bap": pkg.BinnedAveragePrecision(num_classes=CLASSES, thresholds=THRESHOLDS, device=device),
    })


def run_epoch(coll, preds, target, sync):
    """One pass over the epoch; returns the forward values and per-call seconds."""
    forward_vals, update_s, forward_s = [], [], []
    for i, start in enumerate(range(0, ROWS, BATCH)):
        p, y = preds[start:start + BATCH], target[start:start + BATCH]
        t0 = time.perf_counter()
        if i % FORWARD_EVERY == 0:
            forward_vals.append(coll(p, y))
            sync()
            forward_s.append(time.perf_counter() - t0)
        else:
            coll.update(p, y)
            sync()
            update_s.append(time.perf_counter() - t0)
    return forward_vals, update_s, forward_s


def _same_values(a, b, what):
    import torch

    for key in b:
        x, y = a[key], b[key]
        if isinstance(y, list):
            x, y = torch.stack(x).cpu(), torch.stack(y).cpu()
            if x.shape != y.shape or not bool(torch.isfinite(x).all()) or float((x - y).abs().max()) > AP_ATOL:
                raise AssertionError(f"{what}: {key} differs from the CPU run beyond atol={AP_ATOL}")
        elif not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: {key} = {float(x)} on the card, {float(y)} on the CPU")


def phase_main_path(preds, target):
    import torch

    import metrics_tpu_torch as mtt
    from metrics_tpu_torch.ops import binned_counters as k1

    dev = preds.device
    n_batches = -(-ROWS // BATCH)
    coll = build_collection(mtt, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    k1.reset_launch_count()
    t0 = time.perf_counter()
    fwd, update_s, forward_s = run_epoch(coll, preds, target, torch.cuda.synchronize)
    loop_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    result = coll.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t1
    launches = k1.launch_count

    members = dict(coll.items(keep_base=True, copy_state=False))
    for name, m in members.items():
        for key, value in m.metric_state.items():
            if value.device.type != "cuda":
                raise AssertionError(f"state {name}.{key} lies on {value.device}, not on the card")
    if members["bap"].thresholds.device.type != "cuda":
        raise AssertionError("bap thresholds are not on the card")
    bap_updates = members["bap"].update_count
    if not (launches == bap_updates == n_batches):
        raise AssertionError(f"K1 launched {launches} times for {bap_updates} bap updates over {n_batches} batches")

    acc1, acc5, bap = result["acc1"], result["acc5"], result["bap"]
    if acc1.shape != () or acc5.shape != () or len(bap) != CLASSES or any(v.shape != () for v in bap):
        raise AssertionError("results have unexpected shapes")
    bap_t = torch.stack(bap)
    if not (bool(torch.isfinite(bap_t).all()) and 0.0 <= float(acc1) <= float(acc5) <= 1.0):
        raise AssertionError(f"implausible results: acc1={float(acc1)}, acc5={float(acc5)}")
    direct_top1 = (preds.argmax(dim=1) == target).sum().to(torch.float32) / ROWS
    if not torch.equal(acc1, direct_top1):
        raise AssertionError(f"acc1 {float(acc1)} != argmax accuracy {float(direct_top1)}")

    # the same run of the port on the CPU, where K1 is its plain version
    t2 = time.perf_counter()
    cpu = build_collection(mtt, "cpu")
    cpu_fwd, _, _ = run_epoch(cpu, preds.cpu(), target.cpu(), lambda: None)
    cpu_result = cpu.compute()
    cpu_s = time.perf_counter() - t2
    _same_values(result, cpu_result, "compute()")
    for i, (a, b) in enumerate(zip(fwd, cpu_fwd)):
        _same_values(a, b, f"forward call {i}")
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    for name, m in members.items():
        for key, value in m.metric_state.items():
            if not torch.equal(value.cpu(), cpu_members[name].metric_state[key]):
                raise AssertionError(f"state {name}.{key} differs between the card and the CPU")

    emit({
        "phase": "main_path",
        "config": {"rows": ROWS, "classes": CLASSES, "thresholds": THRESHOLDS, "batch": BATCH, "seed": SEED},
        "batches": n_batches,
        "update_calls": len(update_s),
        "forward_calls": len(forward_s),
        "rows_per_s": ROWS / loop_s,
        "epoch_s": loop_s,
        # the first forward and the first update carry one-time costs (lazy
        # loading of each CUDA kernel, compute-group forming)
        "first_forward_ms": forward_s[0] * 1e3,
        "first_update_ms": update_s[0] * 1e3,
        "rows_per_s_after_first_batch": (ROWS - BATCH) / (loop_s - forward_s[0]),
        "update_p50_ms": statistics.median(update_s) * 1e3,
        "forward_p50_ms": statistics.median(forward_s) * 1e3,
        "compute_s": compute_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "k1_launches": launches,
        "acc1": float(acc1),
        "acc5": float(acc5),
        "bap_mean": float(bap_t.mean()),
        "cpu_reference_s": cpu_s,
        "matches_cpu_run": True,
    })
    return launches


def phase_kernel_times(preds, target, launches, max_abs_err, smi):
    import ctypes

    import torch

    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.utilities.data import jax_linspace, to_onehot

    dev = preds.device
    p = preds[:BATCH].contiguous()
    tgt = to_onehot(target[:BATCH], CLASSES) == 1
    thr = jax_linspace(0, 1.0, THRESHOLDS, device=dev)
    n, c, t = BATCH, CLASSES, THRESHOLDS

    # the kernel alone, into one preallocated buffer
    lib = k1._library()
    tgt_u8 = tgt.view(torch.uint8)
    out = torch.zeros((3, c, t), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def raw():
        err = lib.binned_counters_launch(p.data_ptr(), tgt_u8.data_ptr(), thr.data_ptr(), out.data_ptr(), n, c, t, stream)
        if err:
            raise RuntimeError(f"binned_counters launch failed with cudaError {err}")

    wrapper = lambda: k1.binned_counter_update(p, tgt, thr)  # noqa: E731
    plain = lambda: k1.binned_counter_update_plain(p, tgt, thr)  # noqa: E731
    # in turns, so drift on the card touches every version alike
    order = [("plain", plain), ("wrapper", wrapper), ("kernel", raw), ("kernel", raw), ("wrapper", wrapper), ("plain", plain)]
    times = {}
    for name, fn in order:
        times.setdefault(name, []).append(cuda_time_ms(fn))
    ms = {name: statistics.mean(v) for name, v in times.items()}

    bytes_moved = n * c * (4 + 1) + t * 4 + 3 * c * t * 4  # f32 scores, u8 labels, f32 thresholds in; i32 counts out
    compares = n * c * t
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = compares / FP32_OPS_PER_S * 1e3
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "binned_counters",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/binned_counters.cu",
        "replaces": "metrics_tpu/ops/binned_counters.py:32",
        "replaces_fn": "metrics_tpu/ops/binned_counters.py::_counter_kernel",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms["wrapper"],
        "kernel_ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [n, c, t],
        "bytes": bytes_moved,
        "compares": compares,
    }]})


def phase_profile(preds, target, batches=8):
    """Where an update's time goes: each member's update alone, and a
    ``torch.profiler`` window over the collection's updates."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import metrics_tpu_torch as mtt

    def batch(i):
        s = (i % (ROWS // BATCH)) * BATCH
        return preds[s:s + BATCH], target[s:s + BATCH]

    member_p50_ms = {}
    for name, m in build_collection(mtt, preds.device).items(keep_base=True, copy_state=False):
        times = []
        for i in range(batches + 2):
            t0 = time.perf_counter()
            m.update(*batch(i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        member_p50_ms[name] = statistics.median(times[2:]) * 1e3

    coll = build_collection(mtt, preds.device)
    for i in range(3):  # warm-up; compute groups form at the first update
        coll.update(*batch(i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3, 3 + batches):
            coll.update(*batch(i))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    events = prof.key_averages()
    # only the card's own events (kernels, copies): a host op also carries
    # the device time of the kernels it launched, which would count it twice
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in on_device)
    top_device = sorted(on_device, key=dev_us, reverse=True)[:12]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    emit({
        "phase": "profile",
        "batches": batches,
        "member_update_p50_ms": member_p50_ms,
        "wall_ms_per_batch": wall_s * 1e3 / batches,
        "device_busy_ms_per_batch": device_us / 1e3 / batches,
        "device_idle_share": 1.0 - device_us / 1e6 / wall_s,
        "top_device_ms_per_batch": [[e.key, dev_us(e) / 1e3 / batches, e.count // batches] for e in top_device if dev_us(e) > 0],
        "top_host_ms_per_batch": [[e.key, e.self_cpu_time_total / 1e3 / batches, e.count // batches] for e in top_cpu],
    })


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this script measures the port on a GPU and has no CPU mode")
    if not (ROOT / "metrics_tpu_torch" / "__init__.py").is_file() or not (ROOT / "metrics_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (metrics_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({
        "phase": "device",
        "kind": kind,
        "count": count,
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    })
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    device = torch.device("cuda", 0)
    preds, target = make_data(device)
    max_abs_err = phase_parity(preds, target)
    launches = phase_main_path(preds, target)
    phase_profile(preds, target)
    phase_kernel_times(preds, target, launches, max_abs_err, smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})


if __name__ == "__main__":
    main()
