"""ctypes bindings for the native C++ helpers (port of
`gseg_tpu.native.bindings`): the Felzenszwalb baseline (`kruskal_native`)
and the ASA/UE comparetool.

`felz.cpp` is a byte-for-byte copy of the reference's source. It is built
on first use with `g++` and the reference Makefile's flags into
`gseg_tpu_torch/_build/` (`ops.kernels._build.load_host`); a failed build
raises with the compiler's stderr. Both run on the host.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from ..ops.kernels import _build

SOURCE = Path(__file__).resolve().parent / "felz.cpp"


def _load() -> ctypes.CDLL:
    lib = _build.load_host(SOURCE)
    lib.felz_segment.restype = ctypes.c_int
    lib.felz_segment.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.compare_asa_ue.restype = ctypes.c_int
    lib.compare_asa_ue.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def segment_kruskal_native(image: np.ndarray, cfg) -> np.ndarray:
    """C++ Felzenszwalb baseline; same semantics as segment_kruskal_np.
    Returns (H, W) int32 root vertex ids."""
    lib = _load()
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    labels = np.empty(h * w, dtype=np.int32)
    rc = lib.felz_segment(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, ctypes.c_float(cfg.sigma), ctypes.c_float(cfg.k),
        cfg.min_size, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"felz_segment failed with code {rc}")
    return labels.reshape(h, w)


def asa_ue_native(seg: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """C++ ASA/UE comparetool; same result as metrics.compare.asa_ue."""
    lib = _load()
    s = np.ascontiguousarray(seg, dtype=np.int32).ravel()
    g = np.ascontiguousarray(gt, dtype=np.int32).ravel()
    if s.size != g.size:
        raise ValueError("seg and gt must have the same size")
    out = np.zeros(2, dtype=np.float64)
    rc = lib.compare_asa_ue(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        s.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError(f"compare_asa_ue failed with code {rc}")
    return float(out[0]), float(out[1])
