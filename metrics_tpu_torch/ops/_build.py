"""Build and load the port's CUDA kernels.

Each source under ``metrics_tpu_torch/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which ``ctypes``
loads. The library lands in ``metrics_tpu_torch/_build/<name>-<hash>/``,
keyed by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is built once. Nothing is built at import: the first
call on a CUDA tensor builds.

:func:`lane_route` registers, for each kernel, the ``torch.library`` ops
through which a ``torch.func.vmap``-batched call reaches the kernel's
lane-batched form, the counterpart of ``pallas_call``'s batching rule.
"""
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.analysis.lockwitness import named_lock

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# held while nvcc runs: not hot, blocking under it is its job (ROADMAP D64)
_lock = named_lock("_build._lock", threading.Lock(), hot=False)
_loaded: Dict[str, ctypes.CDLL] = {}
# what the last build of each source took and what ptxas said about it
build_info: Dict[str, Dict[str, object]] = {}


# the wrappers' launch counts: one lock for every module's counter, and a
# per-thread record of the launches that a CUDA-graph capture made (the
# capture launches nothing; each replay of the graph launches them)
_count_lock = named_lock("_build._count_lock", threading.Lock(), hot=True)
_recording = threading.local()


def count_launch(module: str, counter: str = "launch_count", n: int = 1) -> None:
    """Add ``n`` to ``<module>.<counter>``, the count that a kernel's wrapper
    keeps of its launches, and to this thread's record while a capture
    records (:func:`record_launches`)."""
    mod = sys.modules[module]
    with _count_lock:
        setattr(mod, counter, getattr(mod, counter) + n)
    record = getattr(_recording, "launches", None)
    if record is not None:
        record[(module, counter)] = record.get((module, counter), 0) + n


class record_launches:
    """Within the block, the launches that this thread's wrappers count are
    also kept in ``self.launches``, ``{(module, counter): n}``."""

    def __enter__(self) -> "record_launches":
        self._outer = getattr(_recording, "launches", None)
        self.launches: Dict[tuple, int] = {}
        _recording.launches = self.launches
        return self

    def __exit__(self, *exc: object) -> None:
        _recording.launches = self._outer


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc was not found (looked on PATH and under $CUDA_HOME/bin); it is needed to build the CUDA kernels")


def batched(*tensors: object) -> bool:
    """True if any of ``tensors`` is batched by ``torch.func.vmap``: it has
    no storage of its own, so a kernel cannot read its data pointer, and its
    wrapper sends it down the lane route (:func:`lane_route`) instead."""
    return any(isinstance(t, torch.Tensor) and torch._C._functorch.is_batchedtensor(t) for t in tensors)


@torch.library.custom_op("metrics_tpu_torch::bit_view", mutates_args=())
def _bit_view_op(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype).clone()


def _bit_view_rule(info: Any, in_dims: Sequence[Optional[int]], x: torch.Tensor, dtype: torch.dtype) -> Any:
    # the same element size: the lane axis keeps its place
    return bit_view(x, dtype).clone(), in_dims[0]


torch.library.register_vmap(_bit_view_op, _bit_view_rule)


def bit_view(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.view(dtype)`` for a dtype of the same element size (a float's
    bits as an integer, or back), also on a ``torch.func.vmap``-batched
    tensor: ``aten::view.dtype`` has no batching rule in every torch release
    (torch 2.11 refuses it), so a batched tensor goes through an op whose
    rule views the lanes' storage, and comes back a copy."""
    return _bit_view_op(x, dtype) if batched(x) else x.view(dtype)


def lane_groups(lanes: int, per_lane: int, limit: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` runs of lanes, in order, each holding at most ``limit``
    units where one lane holds ``per_lane`` (at least one lane a run): how a
    wrapper splits the lanes of one batched call into launches that a
    kernel's 32-bit indices or grid limits can take."""
    step = max(1, limit // max(1, per_lane))
    return [(lo, min(lanes, lo + step)) for lo in range(0, lanes, step)]


def lane_route(name: str, schema: str, lane_args: Sequence[int], shared_args: Sequence[int], lanes_fn: Callable) -> Callable:
    """The route from ``torch.func.vmap`` to a kernel's lane-batched form.

    Registers two ``torch.library`` custom ops of one ``schema``:
    ``metrics_tpu_torch::<name>_lanes``, ``lanes_fn``, which takes a leading
    lane axis on each of ``lane_args`` and gives one on every output, and
    ``metrics_tpu_torch::<name>``, the function of one lane (``lanes_fn``
    over a single lane). A
    wrapper calls the first with vmap-batched tensors; its vmap rule moves
    each lane argument's batch axis to 0 (an unbatched one is expanded over
    the lanes), and runs ``lanes_fn``: the batched kernel on CUDA tensors,
    the plain version with the lane axis written out on CPU tensors. Its
    outputs carry the lanes at axis 0. A nested vmap reaches the rule with
    tensors still batched by the outer level; the rule then calls the
    ``_lanes`` op, whose own rule folds the outer lanes into the inner ones
    (``(outer * inner, ...)``) and unfolds the outputs, at any depth.

    ``shared_args`` (thresholds, their order) are one set for every lane: a
    batched one raises, on every device. The rules add no host read and no
    loop over lanes, so a captured update (``_capture.py``) captures them.
    Returns the per-lane op.
    """
    arg_names = [a.split()[-1] for a in schema[1:schema.index(")")].split(",")]

    def row_fn(*args: Any) -> Any:
        outs = lanes_fn(*(a.unsqueeze(0) if i in lane_args else a for i, a in enumerate(args)))
        return outs[0].clone() if isinstance(outs, torch.Tensor) else tuple(o[0].clone() for o in outs)

    row_op = torch.library.custom_op(f"metrics_tpu_torch::{name}", row_fn, mutates_args=(), schema=schema)
    lanes_op = torch.library.custom_op(f"metrics_tpu_torch::{name}_lanes", lanes_fn, mutates_args=(), schema=schema)

    def to_lanes(info: Any, in_dims: Sequence[Optional[int]], args: Sequence[Any]) -> List[Any]:
        for i in shared_args:
            if in_dims[i] is not None:
                raise ValueError(
                    f"{name}: `{arg_names[i]}` is one set shared by every lane and cannot be batched under "
                    "torch.func.vmap (map the inputs, not the thresholds or their order)"
                )
        out = list(args)
        for i in lane_args:
            d = in_dims[i]
            out[i] = args[i].movedim(d, 0) if d is not None else args[i].expand(info.batch_size, *args[i].shape)
        return out

    def run(args: Sequence[Any]) -> Any:
        # still batched: a vmap outside this one, whose rule folds its lanes in
        return lanes_op(*args) if batched(*args) else lanes_fn(*args)

    def out_dims(outs: Any) -> Any:
        return 0 if isinstance(outs, torch.Tensor) else (0,) * len(outs)

    def row_rule(info: Any, in_dims: Sequence[Optional[int]], *args: Any) -> Any:
        outs = run(to_lanes(info, in_dims, args))
        return outs, out_dims(outs)

    def lanes_rule(info: Any, in_dims: Sequence[Optional[int]], *args: Any) -> Any:
        flat = to_lanes(info, in_dims, args)  # (outer, inner, ...)
        for i in lane_args:
            flat[i] = flat[i].flatten(0, 1)
        outs = run(flat)
        unfold = lambda t: t.unflatten(0, (info.batch_size, -1))  # noqa: E731
        outs = unfold(outs) if isinstance(outs, torch.Tensor) else tuple(unfold(t) for t in outs)
        return outs, out_dims(outs)

    torch.library.register_vmap(row_op, row_rule)
    torch.library.register_vmap(lanes_op, lanes_rule)
    return row_op


def library_path(source: str) -> pathlib.Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}" / f"lib{src.stem}.so"


def build(source: str) -> pathlib.Path:
    """Compile ``csrc/<source>`` unless its library already exists."""
    lib = library_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: a concurrent process never
    # loads a half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    ptxas = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln or "spill" in ln]
    build_info[source] = {"seconds": seconds, "ptxas": ptxas}
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build if needed, then load the library of ``csrc/<source>`` once per process."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
