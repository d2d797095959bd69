"""Fig. 3 study: the conventional (host-synced) against the
device-orchestrated Boruvka loop (port of `gseg_tpu.bench.fig3`).

The reference ran its atomic Felzenszwalb at 480p for 1000 reps in both
modes (Report.pdf p.5, report-extract 486-517; BASELINE.md):
`ab conventional`, a 4-byte convergence-flag device-to-host copy per
Boruvka iteration, and `ab dynamic`, a device-side orchestration kernel
with no host crossing, and reported min/median/max. Its finding: the
device-orchestrated mode had a tighter distribution but a slightly worse
median (4955/5004/5140 us against 4666/4709/6493 us).

The JAX package's modes are `segment_atomic` (the whole loop in
`lax.while_loop` on the device) and `segment_atomic_hostsync` (one jitted
round at a time, the merge flag read on the host each round). In the
port both are the same host loop: `segment_atomic_hostsync` *is*
`segment_atomic_impl` (models/atomic_boruvka.py), which reads `merged` on
the host every round. So on the card this A/B is an A/A, two runs of one
loop under two names, and its spread is the timer's noise floor at 480p.
A device-side loop for the atomic path is later work, not part of the
port.

Each mode: one warm-up call, then --reps calls, each timed on the host
clock up to the moment its labels are ready on the device.

Usage:
    python -m gseg_tpu_torch.bench.fig3 --reps 100 --out fig3.jsonl
    python -m gseg_tpu_torch.bench.fig3 --height 48 --width 64 --reps 3 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _run_mode(fn, img, reps: int) -> dict:
    from ..utils.timing import wait

    wait(fn(img))  # warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        wait(fn(img))
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return {
        "min_s": float(ts.min()),
        "median_s": float(np.median(ts)),
        "max_s": float(ts.max()),
        "mean_s": float(ts.mean()),
        "std_s": float(ts.std()),
        "reps": reps,
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="gseg_tpu_torch.bench.fig3")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=854)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; raises without a "
                         "CUDA device unless this is 'cpu')")
    args = ap.parse_args(argv)

    from .. import _device, _image_on
    from ..config import SegmentationConfig
    from ..models.atomic_boruvka import segment_atomic, segment_atomic_hostsync
    from ..utils.synthetic import blobs_image

    cfg = SegmentationConfig(k=300.0, min_size=100)
    img = _image_on(blobs_image(args.height, args.width, num_blobs=12,
                                noise=8.0, seed=0), _device(args.device))

    rows = []
    for mode, fn in (
        ("device_loop", lambda im: segment_atomic(im, cfg)),
        ("hostsync", lambda im: segment_atomic_hostsync(im, cfg)),
    ):
        stats = _run_mode(fn, img, args.reps)
        stats.update({"mode": mode, "height": args.height,
                      "width": args.width})
        rows.append(stats)
        print(json.dumps(stats), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
