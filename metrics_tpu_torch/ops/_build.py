"""Build and load the port's CUDA kernels.

Each source under ``metrics_tpu_torch/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which ``ctypes``
loads. The library lands in ``metrics_tpu_torch/_build/<name>-<hash>/``,
keyed by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is built once. Nothing is built at import: the first
call on a CUDA tensor builds.
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
from typing import Dict, List, Optional

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


def refuse_batched(kernel: str, *tensors: "torch.Tensor") -> None:
    """Raise if any of ``tensors`` is batched by ``torch.func.vmap``.

    A kernel reads raw device pointers, which a batched tensor does not
    have, and a CUDA tensor is never routed to the plain version. The
    per-row deltas of a ``SlicedMetric`` run under ``vmap``, so a member
    whose update launches ``kernel`` is refused here, where it launches.
    """
    if any(torch._C._functorch.is_batchedtensor(t) for t in tensors):
        raise ValueError(
            f"{kernel} cannot launch under torch.func.vmap (a SlicedMetric's per-row deltas), and a CUDA "
            "tensor is never routed to its plain version. Keep the metric unsliced beside the sliced "
            "members; the sliced form of the kernel is a later item (ROADMAP.md, Queue 2, 'sliced K1/K2')."
        )


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
