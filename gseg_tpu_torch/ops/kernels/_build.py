"""Build and load the port's CUDA sources on first use.

Each `gseg_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for sm_90a into
a shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds); `load_host` does the same for
a C++ source of the host with `g++` (the native baseline). Libraries are
cached under `gseg_tpu_torch/_build/`, keyed by a hash of the source and
the flags (and, for `load_host`, the host CPU's model and feature flags,
which `-march=native` builds for). A failed build raises with the compiler's
stderr.
Every C entry point takes device pointers, sizes and the CUDA stream, and
returns `cudaGetLastError()`; `check` turns a nonzero code into an error.
`on_cpu` is the wrappers' one routing rule: the plain PyTorch version for
CPU tensors, the kernel for CUDA tensors, and nothing else.

The wrappers may be called from several threads at once (the ranks of
`gseg_tpu_torch.parallel`): a lock per library serialises its build, and
`LOCK` the bindings and the launch counters (`count`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# the reference's native Makefile's flags. On a host with FMA, GCC
# contracts a*b+c into fused multiply-adds under -march=native in C++ even
# with -std=c++17 (8 in felz.cpp with GCC 12; none with -ffp-contract=off).
# The reference's library is built the same way, so the two agree because
# their flags agree, and no flag is added.
HOST_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
              "-shared"]

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
# library bindings and launch counters (reentrant: a binding loads)
LOCK = threading.RLock()
_build_locks: dict[str, threading.Lock] = {}


def count(wrapper, attr: str = "launches", n: int = 1) -> None:
    """wrapper.<attr> += n under LOCK (a bare += can lose counts between
    threads)."""
    with LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _cached(stem: str, src: Path, cmd: list[str], key: bytes = b"",
            verbose: bool = False) -> ctypes.CDLL:
    """Build `src` with `cmd` (compiler and flags) unless a library of the
    same source, command and key is cached, then load it."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(cmd[1:]).encode() + key
    ).hexdigest()[:16]
    so = BUILD_DIR / f"lib{stem}_{digest}.so"
    if not so.exists() or verbose:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_seconds[stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed on {src}:\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def load(name: str, verbose: bool = False) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if not cached.

    verbose=True adds `-Xptxas -v` and prints the compiler's report
    (registers, shared memory and spills per kernel)."""
    with LOCK:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs and not verbose:
            return _libs[name]
        flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        lib = _cached(name, CSRC / f"{name}.cu", [_nvcc(), *flags],
                      verbose=verbose)
        _libs[name] = lib
        return lib


def load_all(verbose: bool = False) -> None:
    """`load` every csrc/*.cu, one nvcc for each source, all started
    together (the rank threads of `gseg_tpu_torch.parallel` then never
    wait on a first build)."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(load, n, verbose) for n in names]:
            fut.result()


def _cpuinfo() -> dict[str, str]:
    """The first core's fields of /proc/cpuinfo (none where it is not
    readable)."""
    info: dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return info


def host_cpu() -> str:
    """The host CPU, to label host-only times: its model name, or, where
    that reads "unknown", its vendor, family, model and clock; with the
    core count."""
    info = _cpuinfo()
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', platform.machine())} family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')}"
                f" at {info.get('cpu MHz', '?')} MHz (model name not "
                "reported)")
    return f"{name}, {os.cpu_count()} cores"


def _host_key() -> bytes:
    """What `-march=native` builds for: the machine, the CPU's model name
    and its feature flags."""
    info = _cpuinfo()
    return "\n".join([platform.machine()] + [
        info.get(k, "") for k in ("model name", "flags", "Features")
    ]).encode()


def load_host(src: Path) -> ctypes.CDLL:
    """The loaded library for a host C++ source, built with `g++` and
    HOST_FLAGS if not cached."""
    stem = src.stem
    with LOCK:
        lock = _build_locks.setdefault(stem, threading.Lock())
    with lock:
        if stem not in _libs:
            _libs[stem] = _cached(stem, src, ["g++", *HOST_FLAGS],
                                  key=_host_key())
        return _libs[stem]


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
