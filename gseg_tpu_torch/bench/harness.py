"""Quality benchmark harness (port of the quality half of
`gseg_tpu.bench.harness`): the reference's Fig. 4 protocol, ASA/UE per
image against the best of its ground truths (Report.pdf p.5-6 §4.2;
branches `benchmarking` + `comparetool`).

Each callable takes an (H, W, 3) image (array or tensor) and returns
(H, W) int32 labels on `device` (default cuda:0; raises without a CUDA
device unless device="cpu"). Rows are scored on the host, as the
reference scores them. The performance ladder (`run_performance_ladder`,
`_timed`, `prep_fn`) is not ported yet (ROADMAP.md queue 1, item 1).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Sequence

import numpy as np

from ..config import SegmentationConfig


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
