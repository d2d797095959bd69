"""Build and load the port's CUDA sources on first use.

Each `gseg_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for sm_90a into
a shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds). Libraries are cached under
`gseg_tpu_torch/_build/`, keyed by a hash of the source and the flags.
Every C entry point takes device pointers, sizes and the CUDA stream, and
returns `cudaGetLastError()`; `check` turns a nonzero code into an error.
`on_cpu` is the wrappers' one routing rule: the plain PyTorch version for
CPU tensors, the kernel for CUDA tensors, and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def load(name: str, verbose: bool = False) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if not cached.

    verbose=True adds `-Xptxas -v` and prints the compiler's report
    (registers, shared memory and spills per kernel)."""
    if name in _libs and not verbose:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    if not so.exists() or verbose:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _libs[name] = lib
    return lib


def on_cpu(*tensors) -> bool:
    """True if every tensor is on the CPU, False if every one is on one
    CUDA device; raises otherwise (no quiet copy between devices)."""
    if all(x.device.type == "cpu" for x in tensors):
        return True
    if all(x.is_cuda and x.device == tensors[0].device for x in tensors):
        return False
    raise ValueError("tensors must all be on the CPU or all on one CUDA "
                     "device")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
