"""Flagship benchmark: turbo-path throughput at 1080p on one card (the
port's counterpart of the root `bench.py`).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The protocol is the reference's (Report.pdf p.4 §4.1): repeated timed
runs on the same input, disk I/O excluded (the image is on the device
before timing). The image and configuration are `bench.py`'s: 32 blobs,
sigma 0.8, k 300, min_size 100, max_iters 32. One checked warm-up call
raises on a capacity flag; then 5 timed runs of `segment_turbo_flagged`,
each on the host clock up to the moment its labels are ready (the port
reads the flags on the host in every run, so nothing is subtracted).
Baseline: the reference's atomic CUDA path at 1920x1080 on a GTX 1080 Ti,
51.3 ms total (filter + graph + segmentation, decoded Fig. 2a,
BASELINE.md) = 40.4 MPix/s; the timed region covers the same stages.

Usage:
    python -m gseg_tpu_torch.bench.flagship          # cuda:0
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

METRIC = "1080p_turbo_total_throughput"
BASELINE_S = 0.0513  # the reference's atomic total at 1080p, GTX 1080 Ti
REPS = 5


def throughput_line(image, cfg, reps: int = REPS) -> dict:
    """The flagship's line for an (H, W, 3) image tensor on its device:
    MPix/s of the mean of `reps` timed runs after a checked warm-up, and
    the ratio to the baseline's MPix/s at the same pixel count."""
    from ..models.turbo import segment_turbo, segment_turbo_flagged
    from ..utils.timing import wait

    wait(segment_turbo(image, cfg))  # raises on a capacity flag
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        wait(segment_turbo_flagged(image, cfg, 2)[0])
        times.append(time.perf_counter() - t0)
    mean_s = float(np.mean(times))
    mpix = image.shape[0] * image.shape[1] / 1e6
    mpix_per_s = mpix / mean_s
    baseline_mpix_per_s = mpix / BASELINE_S
    return {
        "metric": METRIC,
        "value": round(mpix_per_s, 2),
        "unit": "MPix/s",
        "vs_baseline": round(mpix_per_s / baseline_mpix_per_s, 3),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="gseg_tpu_torch.bench.flagship")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; raises without a "
                         "CUDA device unless this is 'cpu')")
    args = ap.parse_args(argv)

    from .. import _device, _image_on
    from ..config import SegmentationConfig
    from ..utils.synthetic import blobs_image

    cfg = SegmentationConfig(sigma=0.8, k=300.0, min_size=100, max_iters=32,
                             algorithm="turbo")
    img = _image_on(blobs_image(1080, 1920, num_blobs=32, noise=8.0, seed=0),
                    _device(args.device))
    line = throughput_line(img, cfg)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
