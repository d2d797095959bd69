"""The comparison that decides `correct`.

After the window, the plain reference (`reference.py`) works out the
partition of every pool frame that a checked frame showed, in worker
processes of their own (the NumPy Boruvka takes seconds a frame), and each
checked frame's labels are held against it as partitions. The numbers
compared, each with its limit:

  pixels_off     pixels whose component differs from the reference's, over
                 every checked frame; limit 0 (an exact partition)
  frames_failed  frames whose call raised (a capacity flag under
                 on_overflow="raise") or returned nothing; limit 0
  frames_checked frames compared; at least 1
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import reference

# below this many pixels in all, the references run in this process
IN_PROCESS_PIXELS = 1 << 20


def reference_partitions(frames: dict, cfg: dict,
                         precision: str = "float32",
                         workers: int | None = None) -> dict:
    """index -> canonical reference labels for {index: frame}."""
    if sum(f.shape[0] * f.shape[1] for f in frames.values()) \
            < IN_PROCESS_PIXELS:
        return {i: reference.reference_partition(f, cfg, precision)
                for i, f in frames.items()}
    n = workers or max(1, min(len(frames), os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(n, mp_context=ctx) as pool:
        futs = {i: pool.submit(reference.reference_partition, f, cfg,
                               precision) for i, f in frames.items()}
        return {i: fut.result() for i, fut in futs.items()}


def compare(checked: list, refs: dict, failed: int) -> dict:
    """checked: [(pool index, (H, W) labels or None)]. Returns the numbers
    compared, each {"value", "limit"} (frames_checked's limit is a
    least)."""
    off = 0
    for idx, labels in checked:
        ref = refs[idx]
        if labels is None or labels.shape != ref.shape:
            off += ref.size
            continue
        off += int(np.count_nonzero(reference.canonical_labels(labels) != ref))
    return {
        "pixels_off": {"value": off, "limit": 0},
        "frames_failed": {"value": failed, "limit": 0},
        "frames_checked": {"value": len(checked), "limit": 1},
    }


def passed(checks: dict) -> bool:
    return (checks["pixels_off"]["value"] <= checks["pixels_off"]["limit"]
            and checks["frames_failed"]["value"]
            <= checks["frames_failed"]["limit"]
            and checks["frames_checked"]["value"]
            >= checks["frames_checked"]["limit"])


def lines(checks: dict) -> list[str]:
    """The plain lines printed last on standard error."""
    out = []
    for name, c in checks.items():
        rel = "at least" if name == "frames_checked" else "limit"
        out.append(f"check {name} {c['value']} {rel} {c['limit']}")
    return out
