"""Build the package's CUDA kernels and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Builds go to ``ops/build/`` (listed in ``.gitignore``) and happen at first
use; :func:`build` starts every missing ``nvcc`` at once, so the
libraries compile in parallel. :func:`launch` binds a C entry at first
use and calls it on the current stream; every op module launches
through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# library name -> its source; the shared headers are hashed with each
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "flash_heads": "flash_heads.cu",
    "flash_ring": "flash_ring.cu",
    "optim": "optim.cu",
}
HEADERS = ("flash_common.cuh", "sm90_common.cuh", "flash_fwd_sm90.cuh",
           "flash_bwd_sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[str, object] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built from source on the machine with the GPU")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in (SOURCES[name],) + HEADERS:
        digest.update((CSRC / part).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet,
    all ``nvcc`` processes at once. Returns seconds per library built;
    raises with the compiler's output if one fails. The ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside each
    library as ``<lib>.log``."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=log, stderr=subprocess.STDOUT,
        )
        started[name] = (proc, tmp, out, log, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, log, t0) in started.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append((name, out.with_suffix(".log").read_text()))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}\n{text}" for name, text in failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def launch(symbol: str, library: str, argtypes, *args) -> None:
    """Call the C entry ``symbol`` of ``library`` (building and binding it
    at first use) with ``args``, typed by ``argtypes``, and then the
    current stream; raise if it reports a CUDA error. Every entry
    returns ``cudaGetLastError()`` after its launch, which itself is
    asynchronous."""
    fn = _bound.get(symbol)
    if fn is None:
        fn = getattr(load(library), symbol)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[symbol] = fn
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err} at launch")
