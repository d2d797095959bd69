"""Performance and quality benchmark harness (port of
`gseg_tpu.bench.harness`).

The performance half is the reference's Fig. 2 protocol (Report.pdf p.4
§4.1; branch `performance_benchmark`): synthetic images up the resolution
ladder, repeated timed runs of each algorithm on an image already on the
device (disk I/O excluded), with the filter + graph stage (`prep_fn`)
timed on its own. The quality half is its Fig. 4 protocol, ASA/UE per
image against the best of its ground truths (Report.pdf p.5-6 §4.2;
branches `benchmarking` + `comparetool`).

Timing: each rep of `_timed` makes `inner` calls and then waits for the
card once (`torch.cuda.synchronize`), on the host clock. The port reads
the flags on the host in every call (`segment_fn`), so the calls of a rep
do not overlap and a rep's time over `inner` is the time of one call; the
reference's tunnel fence and its 30 ms round-trip subtraction have no
counterpart here.

Each callable takes an (H, W, 3) image (array or tensor) and returns
(H, W) int32 labels on `device` (default cuda:0; raises without a CUDA
device unless device="cpu"). Quality rows are scored on the host, as the
reference scores them.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np

from ..config import SegmentationConfig
from ..utils.timing import wait

# Reference resolution ladder (reference README.md:26).
RESOLUTION_LADDER = (
    (540, 960),
    (720, 1280),
    (1080, 1920),
    (1440, 2560),
    (2160, 3840),
    (2880, 5120),
    (4320, 7680),
)


def _timed(fn: Callable, reps: int, inner: int | None = None
           ) -> Dict[str, float]:
    """Time fn: one warm-up call, then `reps` reps of `inner` calls, each
    rep waiting for the card once at its end. inner (None: estimated from
    one call) scales so that a rep lasts about 0.5 s, clipped to 1..20.

    The stats keys are the reference's (mean_s, std_s, min_s, max_s,
    within5pct, reps, inner) plus median_s, which the reference lacks:
    the port's end-to-end metric is a median (PERF.md §2)."""
    wait(fn())  # warm-up: first-use kernel builds and allocations
    if inner is None:
        t0 = time.perf_counter()
        wait(fn())
        est = time.perf_counter() - t0
        inner = int(np.clip(round(0.5 / max(est, 2e-3)), 1, 20))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x = None
        for _ in range(inner):
            x = fn()
        wait(x)
        times.append((time.perf_counter() - t0) / inner)
    mean = float(np.mean(times))
    return {
        "mean_s": mean,
        "std_s": float(np.std(times)),
        "min_s": float(np.min(times)),
        "max_s": float(np.max(times)),
        # the reference's stability criterion: the share of measurements
        # within 5% of the mean (Report: "95% of measurements within 5%")
        "within5pct": float(np.mean(np.abs(np.array(times) - mean)
                                    <= 0.05 * mean)) if mean > 0 else 0.0,
        "reps": reps,
        "inner": inner,
        "median_s": float(np.median(times)),
    }


def card(device) -> str:
    """The name and power limit of `device`'s card as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (a card
    set below its maximum power runs slower under load: every time a
    record keeps stands beside this), or "cpu"."""
    import subprocess

    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def segment_fn(algorithm: str, cfg: SegmentationConfig, checked: bool = True,
               device=None):
    """End-to-end segmentation callable for `algorithm` on `device`: the
    port's `segment` with `cfg` on that route. `checked` keeps the
    reference's signature and changes nothing: the port reads the flags on
    the host in every run, so an unchecked variant would save no read."""
    from .. import _device, segment

    dev = _device(device)
    cfg = dataclasses.replace(cfg, algorithm=algorithm)
    return lambda img: segment(img, config=cfg, device=dev)


def segment_level_fn(algorithm: str, cfg: SegmentationConfig,
                     level: int = 4, device=None):
    """Hierarchy-level-`level` segmentation callable (the reference's
    quality protocol scores BSDS500 at hierarchy level 4, report-extract
    651-658). Hierarchy algorithms return their level-`level` label map
    (clamped to the last level); the others (atomic, the CPU baselines)
    return their final labels, as in the reference."""
    from .. import _device, segment_hierarchy

    if algorithm not in ("turbo", "fastmst", "superpixel"):
        return segment_fn(algorithm, cfg, device=device)
    dev = _device(device)
    cfg = dataclasses.replace(cfg, algorithm=algorithm)

    def run(img):
        levels = segment_hierarchy(img, config=cfg, device=dev)[0]
        return levels[min(level, levels.shape[0] - 1)]
    return run


def prep_fn(cfg: SegmentationConfig):
    """The filter + graph-creation stage alone (for phase attribution):
    image -> (w8, eid8) on the image's device."""
    from ..models.atomic_boruvka import prepare_graph

    return functools.partial(prepare_graph, cfg=cfg)


def flagged_fn(algorithm: str, cfg: SegmentationConfig):
    """The flagged entry the ladder reads flags from after its timed reps
    (image -> (labels, int flags)), or None for an algorithm without
    flags, as at the reference's harness.py:227-242."""
    if algorithm == "turbo":
        from ..models.turbo import segment_turbo_flagged

        return lambda img: segment_turbo_flagged(img, cfg, 2)
    if algorithm == "fastmst":
        from ..models.fastmst import segment_fastmst_flagged

        return lambda img: segment_fastmst_flagged(img, cfg)
    if algorithm == "superpixel":
        from ..models.superpixel import segment_superpixel_flagged

        return lambda img: segment_superpixel_flagged(img, cfg)
    return None


def ladder_image(h: int, w: int, content: str = "blobs") -> np.ndarray:
    """The ladder's image at one rung: blobs (piecewise-constant regions
    and noise, whose partitions the committed oracles hold) or textured
    (photo-like multi-octave value noise)."""
    from ..utils.synthetic import blobs_image, textured_image

    if content == "textured":
        return textured_image(h, w, seed=0)
    return blobs_image(h, w, num_blobs=max(8, (h * w) // 65536), seed=0)


def run_performance_ladder(
    algorithms: Sequence[str] = ("turbo",),
    resolutions: Sequence = RESOLUTION_LADDER,
    reps: int = 20,
    cfg: SegmentationConfig | None = None,
    out_path: str | None = None,
    content: str = "blobs",
    device=None,
) -> List[dict]:
    """Reference Fig. 2 protocol on synthetic ladder images.

    content: "blobs" (the tuned-on default) or "textured" (de-risks
    blob-specific capacity tuning; the reference benchmarks photographs,
    reference README.md:26). device: as in `gseg_tpu_torch.segment`.

    Returns one JSON-able row per (algorithm, resolution) with total and
    filter+graph phase stats, and the flags of one flagged call made after
    the timed reps (same input and config, so the same flags), so that a
    capacity overflow cannot hide inside a headline number. The timed
    calls are checked ones: with on_overflow "raise" the warm-up call
    already raises on a flag.
    """
    from .. import _device, _image_on

    dev = _device(device)
    cfg = cfg or SegmentationConfig(k=300.0, min_size=100)
    rows: List[dict] = []
    for h, w in resolutions:
        img = _image_on(ladder_image(h, w, content), dev)
        prep = prep_fn(cfg)
        prep_stats = _timed(lambda: prep(img)[0], reps)
        for algo in algorithms:
            fn = segment_fn(algo, cfg, checked=False, device=dev)
            total = _timed(lambda: fn(img), reps)
            flagged = flagged_fn(algo, cfg)
            flags_val = int(flagged(img)[1]) if flagged else 0
            rows.append({
                "flags": flags_val,
                "algorithm": algo,
                "content": content,
                "height": h,
                "width": w,
                "mpix": h * w / 1e6,
                "total": total,
                "filter_graph": prep_stats,
                "segmentation_s": max(
                    total["mean_s"] - prep_stats["mean_s"], 0.0),
                "mpix_per_s": (h * w / 1e6) / total["mean_s"]
                if total["mean_s"] > 0 else float("inf"),
            })
        del img  # the next rung's tensors start from a free card
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def run_quality_benchmark(
    images_gts: Iterable,
    algorithms: Sequence[str] = ("turbo", "kruskal_native"),
    cfg: SegmentationConfig | None = None,
    out_path: str | None = None,
    device=None,
) -> List[dict]:
    """Reference Fig. 4 protocol: ASA/UE per image, best ground truth.

    images_gts: iterable of (name, image (H,W,3) uint8, [gt label maps]).
    Reference settings: K=80, min_size=100 on BSDS500 (report-extract
    651-658). Each image moves to the device once; its labels come back
    to the host to be scored.
    """
    from .. import _device, _image_on
    from ..metrics.compare import asa_ue_best_gt
    from ..utils.labels import compact_labels_np

    dev = _device(device)
    cfg = cfg or SegmentationConfig(k=80.0, min_size=100)
    rows: List[dict] = []
    fns = {a: segment_fn(a, cfg, device=dev) for a in algorithms}
    for name, image, gts in images_gts:
        dev_img = _image_on(image, dev)
        for algo, fn in fns.items():
            labels = fn(dev_img).cpu().numpy()
            asa, ue = asa_ue_best_gt(compact_labels_np(labels), gts)
            rows.append(
                {"image": name, "algorithm": algo, "asa": asa, "ue": ue}
            )
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def summarize_quality(rows: List[dict]) -> Dict[str, dict]:
    """Per-algorithm ASA/UE medians (the reference's headline numbers)."""
    out: Dict[str, dict] = {}
    algos = sorted({r["algorithm"] for r in rows})
    for a in algos:
        asas = [r["asa"] for r in rows if r["algorithm"] == a]
        ues = [r["ue"] for r in rows if r["algorithm"] == a]
        out[a] = {
            "asa_median": float(np.median(asas)),
            "ue_median": float(np.median(ues)),
            "n": len(asas),
        }
    return out
