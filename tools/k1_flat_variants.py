"""K1 at few classes and many rows, its designs side by side on one CUDA card.

``python3 tools/k1_flat_variants.py [--check] [--out FILE]``
    Builds ``metrics_tpu_torch/csrc/binned_counters.cu`` as it stands and
    variants of it (one ``nvcc`` each, all at once):

    - ``plan``: the source, whose plan sends C <= 8 and N * C >= 2^20 (times
      the lanes) to the flat design;
    - ``previous``: the flat plan takes no shape, so the unbatched call runs
      the binary-search histogram (``binned_counters_kernel``) and the
      many-row lanes the one-pass kernel (``binned_counters_lanes_kernel``),
      the designs before the flat one;
    - ``one_copy``: the flat design with one copy of a block's histogram
      instead of one a warp lane's slot (``one_copy_stage_1``: and one
      vector loaded ahead);
    - ``stage_1``, ``stage_4``: the flat design loading one or four vectors
      ahead of those it bins instead of two;
    - ``four_blocks``: the flat design held to four 512-thread blocks an SM
      (32 registers a thread, ``__launch_bounds__``).

    At a binary PR curve over pixel scores (C = 1, T = 100: 2^20, 2^24 and
    2^25 rows unbatched, two lanes of 2^24 rows) and at C = 3 (2^22 rows), with
    uniform scores and with a background-heavy draw (90 % of the scores in
    one bin), each variant's output is held bit-equal to the plain version
    on the card, then timed by the profiler's device time (median launch).
    ``--check`` holds the outputs only, at every case and at a misaligned
    view. It prints a JSON line a variant, the card's name and power limit
    first, and writes them to ``--out`` if given. Torch only; the builds go
    to ``metrics_tpu_torch/_build/variants``.

:func:`previous_library` is the ``previous`` build with the wrapper's
argument types, which ``chip_smoke.py`` times beside the flat design.
"""
import argparse
import concurrent.futures as cf
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PLAN_ANCHOR = "int flat_plan(int lanes, int n, int c, int t, FlatPlan* pl) {\n"
BOUNDS_ANCHOR = "__global__ void __launch_bounds__(kFlatThreads)\nbinned_counters_flat_kernel("
VARIANTS = {
    "plan": [],
    "previous": [(PLAN_ANCHOR, PLAN_ANCHOR + "  if (pl) return 1;  // the flat design takes no shape\n")],
    "one_copy": [("constexpr int kMaxCopies = 32;", "constexpr int kMaxCopies = 1;")],
    "stage_1": [("constexpr int kFlatStage = 2;", "constexpr int kFlatStage = 1;")],
    "stage_4": [("constexpr int kFlatStage = 2;", "constexpr int kFlatStage = 4;")],
    "four_blocks": [(BOUNDS_ANCHOR, "__global__ void __launch_bounds__(kFlatThreads, 4)\nbinned_counters_flat_kernel(")],
    "one_copy_stage_1": [("constexpr int kMaxCopies = 32;", "constexpr int kMaxCopies = 1;"),
                         ("constexpr int kFlatStage = 2;", "constexpr int kFlatStage = 1;")],
}
THRESHOLDS = 100
# (label, lanes, rows, classes)
CASES = (("rows_2^20", 1, 1 << 20, 1), ("rows_2^24", 1, 1 << 24, 1), ("rows_2^25", 1, 1 << 25, 1),
         ("lanes_2x2^24", 2, 1 << 24, 1), ("c3_rows_2^22", 1, 1 << 22, 3))
KERNELS = {"flat": "binned_counters_flat_kernel", "unbatched": "binned_counters_kernel", "lanes": "binned_counters_lanes_kernel"}


def variant_source(name):
    from metrics_tpu_torch.ops import _build
    from metrics_tpu_torch.ops import binned_counters as k1

    source = (_build.CSRC_DIR / k1.SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise SystemExit(f"{name}: the source does not hold {old!r} once")
        source = source.replace(old, new)
    return source


def build(name):
    """The variant's library, built once for its source and the flags."""
    from metrics_tpu_torch.ops import _build

    source = variant_source(name)
    digest = hashlib.sha256(source.encode() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libbinned_counters_{name}-{digest}.so"
    if so.exists():
        return so
    cu = out_dir / f"binned_counters_{name}-{digest}.cu"
    cu.write_text(source)
    tmp = so.with_name(so.name + ".tmp")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp), str(cu)], capture_output=True, text=True)
    so.with_suffix(".log").write_text(done.stdout + done.stderr)
    if done.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{done.stderr[-3000:]}")
    tmp.replace(so)
    return so


def typed(so):
    """The variant's library with the wrappers' argument types."""
    from metrics_tpu_torch.ops import _build
    from metrics_tpu_torch.ops import binned_counters as k1

    lib = ctypes.CDLL(str(so))
    load = _build.load
    _build.load = lambda source: lib
    try:
        return k1._library()
    finally:
        _build.load = load


def previous_library():
    return typed(build("previous"))


def scores(n, dev, gen, skewed):
    """``n`` float32 scores in [0, 1), 0.1 % NaN; ``skewed``: 90 % of them
    in [0, 0.005), one bin of ``THRESHOLDS`` evenly spread thresholds (a
    mostly-background score map)."""
    import torch

    s = torch.rand(n, generator=gen, device=dev)
    if skewed:
        low = torch.rand(n, generator=gen, device=dev) < 0.9
        s = torch.where(low, s * 0.005, s)
    s[torch.rand(n, generator=gen, device=dev) < 0.001] = float("nan")
    return s


def raw_launch(lib, p, y, thr, order):
    """``fn`` that launches ``lib``'s entry for ``p``/``y`` ((n, c) or
    (lanes, n, c)) into preallocated buffers, its scratch zeroed first, and
    the output it writes."""
    import torch

    lanes_form = p.ndim == 3
    lanes, n, c = p.shape if lanes_form else (1, *p.shape)
    t = thr.shape[0]
    s_thr, perm = order
    u8 = y.view(torch.uint8)
    out = torch.empty((lanes, 3, c, t), dtype=torch.float32, device=p.device)
    scratch = torch.zeros((lanes * (2 * c * (t + 1) + c),), dtype=torch.int32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream

    def fn():
        scratch.zero_()
        if lanes_form:
            err = lib.binned_counters_lanes_launch(p.data_ptr(), u8.data_ptr(), s_thr.data_ptr(), perm.data_ptr(),
                                                   scratch.data_ptr(), out.data_ptr(), lanes, n, c, t, stream)
        else:
            err = lib.binned_counters_launch(p.data_ptr(), u8.data_ptr(), s_thr.data_ptr(), perm.data_ptr(),
                                             scratch.data_ptr(), out.data_ptr(), n, c, t, stream)
        if err:
            raise RuntimeError(f"binned_counters launch failed with cudaError {err}")

    return fn, out if lanes_form else out[0]


def kernel_of(lib, lanes_form, lanes, n, c):
    if lib.binned_counters_flat_plan(lanes, n, c, THRESHOLDS) > 0:
        return KERNELS["flat"]
    return KERNELS["lanes" if lanes_form else "unbatched"]


def inputs(dev, lanes, n, c, skewed, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    p = scores(lanes * n * c, dev, g, skewed).reshape(lanes, n, c)
    y = (torch.rand((lanes, n, c), generator=g, device=dev) < 0.25)
    return (p, y) if lanes > 1 else (p[0], y[0])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="hold every variant bit-equal to the plain version, time nothing")
    parser.add_argument("--out", type=pathlib.Path, default=None)
    args = parser.parse_args()
    import torch

    import chip_smoke as cs
    from metrics_tpu_torch.ops import binned_counters as k1
    from metrics_tpu_torch.utilities.data import jax_linspace

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    lines = [cs.nvidia_smi_line()]
    print(lines[0], flush=True)
    with cf.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    libs = {name: typed(so) for name, so in built.items()}
    log = built["plan"].with_suffix(".log")
    if log.exists():
        # registers, shared memory and spills of the flat kernel's two instances
        ptxas = [ln.strip() for ln in log.read_text().splitlines() if "ptxas info" in ln or "spill" in ln]
        lines.append(json.dumps({"ptxas_plan": ptxas}))
        print(lines[-1], flush=True)
    dev = torch.device("cuda", 0)
    thr = jax_linspace(0, 1.0, THRESHOLDS, device=dev)
    order = k1.threshold_order(thr)
    results = {name: {} for name in VARIANTS}
    for case, lanes, n, c in CASES:
        for skewed in (False, True):
            label = f"{case}_{'skewed' if skewed else 'uniform'}"
            p, y = inputs(dev, lanes, n, c, skewed, seed=len(label) + n)
            views = [("", p, y)]
            if args.check and lanes == 1:
                # scores 4 bytes past a 16-byte boundary, labels 3 bytes past a 4-byte one
                m = (n - 1) * c
                ybuf = torch.cat([y.reshape(-1)[:3], y.reshape(-1)])
                views.append(("_misaligned", p.reshape(-1)[1:1 + m].view(n - 1, c), ybuf[3:3 + m].view(n - 1, c)))
            for suffix, pp, yy in views:
                want = (k1.binned_counter_update_lanes_plain if pp.ndim == 3 else k1.binned_counter_update_plain)(pp, yy, thr)
                want = torch.stack(want, dim=-3)
                for name, lib in libs.items():
                    fn, got = raw_launch(lib, pp, yy, thr, order)
                    fn()
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                        raise SystemExit(f"{name}: {label}{suffix} differs from the plain version")
                    if args.check or suffix:
                        results[name][label + suffix] = {"bit_equal": True}
                        continue
                    kname = kernel_of(lib, pp.ndim == 3, lanes, n, c)
                    ms, recorded = cs.device_ms_per_launch(fn, kname, iters=20)
                    bound = cs._bound(lanes * (n * c * 5 + 3 * c * THRESHOLDS * 4) + THRESHOLDS * 4, lanes * n * c * THRESHOLDS)
                    results[name][label] = {"kernel": kname, "device_ms": ms, "launches_recorded": recorded, **bound}
                del want
            del p, y
            torch.cuda.empty_cache()
    for name, res in results.items():
        line = json.dumps({"variant": name, "cases": res})
        lines.append(line)
        print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
