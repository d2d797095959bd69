"""Phase profiler for the turbo path (port of `gseg_tpu.bench.profile_turbo`).

Times cumulative prefixes of the pipeline (prep -> +gossip -> +extract ->
+stage 2 -> full), each a callable of its own, so a phase's cost is the
difference of adjacent rows. Also reports the stage-G and stage-2 round
counts and the capacity flags, the diagnostics that size every capacity
(see models/turbo.py).

Each row: phase, h, w, mean_s and min_s of --reps timed calls (host clock,
each call ending in a host read of one scalar, which waits for the card),
compile_s (the first call: the reference's jit compile; here first-use
costs, a kernel build among them unless the kernels were built before,
e.g. by `ops.kernels._build.load_all()`), and for every prefix past prep
its iters (stage-G rounds, stage-2 rounds at s2; 0 at full) and flags.
With --trace-dir, one more call of each prefix runs under
`utils.timing.profile_trace`, whose Chrome trace goes there, and on a card
the row gains device_s: the device time of that call (its kernels and
copies, `utils.timing.device_seconds`), beside the wall time.

Usage:
    python -m gseg_tpu_torch.bench.profile_turbo --height 1080 --width 1920
    python -m gseg_tpu_torch.bench.profile_turbo --height 48 --width 64 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch


def phase_fns(cfg, gossip_rounds: int):
    """name -> the cumulative prefix ending at that phase: image -> a tuple
    of (a scalar tensor, and past prep: iters, flags)."""
    from ..models import turbo
    from ..ops import filters
    from ..ops import grid_graph as gg

    def f_prep(im):
        sm = filters.gaussian_smooth(im, cfg.sigma)
        wts, _ = gg.edge_weight_planes(
            sm, cfg.connectivity, cfg.quantize_weight_bits)
        return (torch.isfinite(wts).sum(),)  # invalid slots hold +inf

    def f_gossip(im):
        gst, _, _ = turbo._stage_g(im, cfg, gossip_rounds)
        return gst.L.max(), gst.it, gst.flags

    def f_extract(im):
        gst, wts, _ = turbo._stage_g(im, cfg, gossip_rounds)
        st, _, _ = turbo._extract_stage(gst, wts, cfg)
        return st.esrc.max(), gst.it, st.flags

    def f_s2(im):
        h, w = im.shape[:2]
        gst, wts, thr = turbo._stage_g(im, cfg, gossip_rounds)
        st, _, r0 = turbo._extract_stage(gst, wts, cfg)
        st = turbo._s2_stage(st, h * w, cfg, thr, r0)
        return st.fin.max(), st.it, st.flags

    def f_full(im):
        labels, flags = turbo.segment_turbo_impl(im, cfg, gossip_rounds)
        return labels.max(), 0, flags

    return {"prep": f_prep, "gossip": f_gossip, "extract": f_extract,
            "s2": f_s2, "full": f_full}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="gseg_tpu_torch.bench.profile_turbo")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--weight-buckets", type=int, default=0)
    ap.add_argument("--gossip-rounds", type=int, default=2)
    ap.add_argument("--phases", default="prep,gossip,extract,s2,full")
    ap.add_argument("--trace-dir", default=None,
                    help="profile one more call of each prefix and write "
                         "its trace here")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; raises without a "
                         "CUDA device unless this is 'cpu')")
    args = ap.parse_args(argv)

    from .. import _device, _image_on
    from ..config import SegmentationConfig
    from ..utils.synthetic import blobs_image
    from ..utils.timing import device_seconds, profile_trace

    h, w = args.height, args.width
    cfg = SegmentationConfig(
        k=300.0, min_size=100, algorithm="turbo",
        weight_buckets=args.weight_buckets)
    dev = _device(args.device)
    img = _image_on(blobs_image(h, w, num_blobs=max(8, (h * w) // 65536),
                                noise=8.0, seed=0), dev)
    fns = phase_fns(cfg, args.gossip_rounds)
    rows = []
    for name in args.phases.split(","):
        fn = fns[name]
        t0 = time.perf_counter()
        out = fn(img)
        _ = int(out[0])  # a host read: waits for the card
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = fn(img)
            _ = int(out[0])
            ts.append(time.perf_counter() - t0)
        row = {
            "phase": name,
            "h": h,
            "w": w,
            "mean_s": round(float(np.mean(ts)), 4),
            "min_s": round(float(np.min(ts)), 4),
            "compile_s": round(compile_s, 1),
        }
        if len(out) == 3:
            row["iters"] = int(out[1])
            row["flags"] = int(out[2])
        if args.trace_dir:
            with profile_trace(args.trace_dir) as prof:
                _ = int(fn(img)[0])
            if dev.type == "cuda":
                row["device_s"] = round(device_seconds(prof), 4)
            # the profile's events hold reference cycles: free them before
            # the next phase is timed
            del prof
            gc.collect()
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
