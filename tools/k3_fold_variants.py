"""K3's single fold, its designs side by side on one CUDA card.

``python3 tools/k3_fold_variants.py [--out FILE]``
    Builds ``metrics_tpu_torch/csrc/compactor_fold.cu`` as it stands and
    three variants of it (one ``nvcc`` each, all at once):

    - ``plan``: the source, whose plan runs the slot kernel where the
      lanes' slot blocks fit on the card at once and the tiles past that;
    - ``slots``: the plan always the slot kernel;
    - ``tiles``: the plan always the tiles;
    - ``tiles_searching``: the tiles, with a grid of a thread for every
      position a fold can keep where the plan would run the slots, and a
      lane of two non-empty runs searching each of its kept positions in
      the valid prefixes instead of merging tiles.

    Each is timed beside the first design (``compactor_fold_search_launch``)
    by the profiler's device time: the sketch insert level by level under
    ``torch.func.vmap`` (8 sketches of 20 levels at k = 6600, a 4096-item
    run from level 8; 11 lane-batched folds a call) into an empty level
    (absorbing) and into a level that holds a run already (promoting); one
    lane-batched fold of those levels at 8 to 100 lanes; and one unbatched
    fold at an insert's shape and at a merge's (5000 of a level, 9000 of a
    3k run). Every output is held bit-equal to the plain version first. It
    prints a JSON line a variant (ms a call of the per-level insert, ms a
    launch of a fold, the launches the profiler recorded), the card's name
    and power limit first, and writes them to ``--out`` if given. Torch
    only; the build goes to ``metrics_tpu_torch/_build/variants``.
"""
import argparse
import concurrent.futures as cf
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEARCHING = """  // a lane of two non-empty runs, where the grid has a thread for each
  // position the fold keeps: each thread searches its own position
  const int kept = overflow ? pairs + leftover : c;
  if (ca > 0 && cb > 0 && kept <= (int)(gridDim.x * blockDim.x)) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (!overflow) {
      if (t < c) items[t] = merged_at(a, ca, b, cb, t);
    } else if (t < pairs) {
      promoted[t] = merged_at(a, ca, b, cb, 2 * t + (t & 1));
    } else if (t == pairs && leftover) {
      items[0] = merged_at(a, ca, b, cb, c - 1);
    }
    return;
  }
"""
TILE_ANCHOR = "  const int p0 = blockIdx.x * kTile;  // this tile's merged positions [p0, p1)\n"
PLAN_ANCHOR = "  return (long long)lanes * blocks <= wave ? 1 : 0;"
FOLD_ANCHOR = "  if (fold_slots(lanes, na, nb, k)) {"
GRID_ANCHOR = "    const long long tiles = ((long long)na + nb + kTile - 1) / kTile;\n"
SEARCH_GRID = """    const long long n = (long long)na + nb;
    const long long absorbed = k < n ? k : n;
    const long long most = absorbed > (n + 1) / 2 ? absorbed : (n + 1) / 2;
    long long tiles = (n + kTile - 1) / kTile;
    if (fold_slots(lanes, na, nb, k) && (most + kThreads - 1) / kThreads > tiles) tiles = (most + kThreads - 1) / kThreads;
"""
VARIANTS = {
    "plan": [],
    "slots": [(PLAN_ANCHOR, "  return 1;")],
    "tiles": [(FOLD_ANCHOR, "  if (false) {")],
    "tiles_searching": [(TILE_ANCHOR, SEARCHING + TILE_ANCHOR), (FOLD_ANCHOR, "  if (false) {"), (GRID_ANCHOR, SEARCH_GRID)],
}
LEVELS, K, M, LEVEL, LANES = 20, 6600, 4096, 8, 8
FOLD_LANES = (8, 16, 24, 32, 48, 100)


def build(name, subs, source, out_dir):
    from metrics_tpu_torch.ops import _build

    for old, new in subs:
        if source.count(old) != 1:
            raise SystemExit(f"{name}: the source does not hold {old!r} once")
        source = source.replace(old, new)
    cu = out_dir / f"{name}.cu"
    cu.write_text(source)
    so = out_dir / f"lib{name}.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{done.stderr[-3000:]}")
    return so


def typed(so):
    """The variant's library with the wrappers' argument types."""
    from metrics_tpu_torch.ops import _build
    from metrics_tpu_torch.ops import compactor as k3

    lib = ctypes.CDLL(str(so))
    load = _build.load
    _build.load = lambda source: lib
    try:
        return k3._library()
    finally:
        _build.load = load


def inputs(dev):
    """The two states of 8 sketches, the run, and the single folds."""
    import torch

    from metrics_tpu_torch.ops import compactor as k3

    g = torch.Generator(device=dev).manual_seed(7)

    def rows(counts, n=K):
        vals = torch.sort(torch.rand(counts.shape + (n,), generator=g, device=dev), dim=-1).values
        return torch.where(torch.arange(n, device=dev) < counts[..., None], vals, float("inf")).contiguous()

    counts = torch.randint(0, K + 1, (LANES, LEVELS), generator=g, device=dev, dtype=torch.int32)
    counts[:, :LEVEL + 1] = 0
    items = rows(counts)
    inc = rows(torch.full((LANES,), M, device=dev), M)
    inc_count = torch.full((LANES,), M, dtype=torch.int32, device=dev)
    states = {"absorbing": (items, counts)}
    states["promoting"] = tuple(x.contiguous() for x in k3.fold_cascade_lanes_plain(items, counts, inc, inc_count, LEVEL))
    folds = {}
    for state, (it, ct) in states.items():
        for n in FOLD_LANES:
            idx = torch.arange(n, device=dev) % LANES
            folds[f"{state}_{n}_lanes"] = (it[idx, LEVEL].contiguous(), ct[idx, LEVEL].contiguous(), inc[idx].contiguous(),
                                           inc_count[idx].contiguous())
    one = lambda c: torch.tensor(c, dtype=torch.int32, device=dev)  # noqa: E731
    folds["insert_unbatched"] = tuple(x[0] for x in folds["absorbing_8_lanes"])
    folds["merge_unbatched"] = (rows(one(5000)), one(5000), rows(one(9000), 3 * K), one(9000))
    return states, (inc, inc_count), folds


def time_variant(name, lib, states, run, folds):
    import torch

    import chip_smoke as cs
    from metrics_tpu_torch.ops import compactor as k3

    first = name == "first_design"
    kernel = "compactor_fold_search_kernel" if first else cs.FOLD_KERNELS
    inc, inc_count = run
    out = {}
    library = k3._library
    k3._library = lambda: lib
    try:
        for state, (items, counts) in states.items():
            def per_level(items=items, counts=counts):
                return torch.func.vmap(lambda i, c, r, rc: k3.fold_cascade_plain(i, c, r, rc, LEVEL, fold=k3.compactor_fold))(
                    items, counts, inc, inc_count)

            fn = per_level
            if first:
                def fn(per_level=per_level):
                    with cs._fold_lanes_entry(lib, lib.compactor_fold_search_lanes_launch):
                        return per_level()

            want = k3.fold_cascade_lanes_plain(items, counts, inc, inc_count, LEVEL)
            if not all(torch.equal(x, y) for x, y in zip(fn(), want)):
                raise SystemExit(f"{name}: the per-level insert ({state}) differs from the plain cascade")
            prof = cs.device_profile(fn, kernel, iters=10, per_launch=LEVELS - 1 - LEVEL, host=False)
            out[f"per_level_{state}"] = {"ms_a_call": prof["ms_per_call"], "launches_recorded": prof["recorded_launches"]}
        for label, (a, ac, b, bc) in folds.items():
            lanes = a.ndim == 2
            entry = {(False, False): lib.compactor_fold_launch, (False, True): lib.compactor_fold_lanes_launch,
                     (True, False): lib.compactor_fold_search_launch, (True, True): lib.compactor_fold_search_lanes_launch}[first, lanes]
            fn, got = cs._fold_raw(entry, a, ac, b, bc, K)
            fn()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, k3.compactor_fold_lanes_plain(a, ac, b, bc, K))):
                raise SystemExit(f"{name}: the fold {label} differs from its plain version")
            ms, recorded = cs.device_ms_per_launch(fn, kernel, iters=30)
            out[label] = {"ms_a_launch": ms, "launches_recorded": recorded}
    finally:
        k3._library = library
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=pathlib.Path, default=None)
    args = parser.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(cs.nvidia_smi_line(), flush=True)
    source = (ROOT / "metrics_tpu_torch/csrc/compactor_fold.cu").read_text()
    out_dir = ROOT / "metrics_tpu_torch/_build/variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    with cf.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv, source, out_dir), VARIANTS.items())))
    libs = {name: typed(so) for name, so in built.items()}
    libs["first_design"] = libs["plan"]
    dev = torch.device("cuda", 0)
    states, run, folds = inputs(dev)
    reps = {}
    for rep in range(2):  # every variant twice, in turns
        for name, lib in libs.items():
            got = time_variant(name, lib, states, run, folds)
            for case, v in got.items():
                reps.setdefault(name, {}).setdefault(case, []).append(v)
    summary = {name: {case: {"ms": statistics.mean(v.get("ms_a_call", v.get("ms_a_launch")) for v in vs),
                             "unit": "a call" if "ms_a_call" in vs[0] else "a launch",
                             "launches_recorded": [v["launches_recorded"] for v in vs]}
                      for case, vs in cases.items()}
               for name, cases in reps.items()}
    for name, cases in summary.items():
        print(json.dumps({"variant": name, **cases}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": cs.nvidia_smi_line(), "variants": summary}, indent=1))


if __name__ == "__main__":
    main()
