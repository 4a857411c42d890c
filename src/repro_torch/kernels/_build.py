"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file has a plain C interface and includes no PyTorch
header, so `nvcc` compiles it in seconds into a shared library that
`ctypes` loads; the wrappers pass tensor pointers and the current stream
as integers.  All sources compile in parallel, for `sm_90a`, at first
use, into `build/torch_kernels/` at the root of the checkout (listed in
`.gitignore`).  A library's file name carries a hash of its source, of
every shared header in `csrc/` (`*.cuh`) and of the flags, so an edited
source or header rebuilds and an unchanged one is reused.

`variants(sink)` collects, for the calling thread, the kernel variants
the wrappers launch while it is open (`taken`): the (kernel, shape
class) pairs an index entry point has taken, which stand where a jit's
traced variants would.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: what the last build did: {"seconds": float, "log": {name: ptxas text}}
last_build: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit (nvcc on PATH or CUDA_HOME set)")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{tag}.so"


def _build_all() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    jobs = {}
    for src in sources:
        out = _library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    log = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        text, _ = proc.communicate()
        log[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for src in sources:
        _libs[src.stem] = ctypes.CDLL(str(_library_path(src)))
    last_build.update(seconds=time.perf_counter() - t0, log=log)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building every kernel on
    the first call."""
    with _lock:
        if not _libs:
            _build_all()
        return _libs[name]


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


_taken = threading.local()


def taken(kernel: str, shape_class: str = "") -> None:
    """Note a launch of `kernel`'s `shape_class` variant in the calling
    thread's open `variants` scope, if there is one."""
    sink = getattr(_taken, "sink", None)
    if sink is not None:
        sink.add((kernel, shape_class))


@contextmanager
def variants(sink: set):
    """Add to `sink` the (kernel, shape class) pairs this thread launches
    inside the block; while an inner scope is open, its launches go to
    the inner sink only."""
    outer = getattr(_taken, "sink", None)
    _taken.sink = sink
    try:
        yield sink
    finally:
        _taken.sink = outer
