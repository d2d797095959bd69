"""Command-line interface (port of `gseg_tpu.cli`, the reference's L4 CLI
apps): one image in, a coloured segmentation out.

    python -m gseg_tpu_torch INPUT OUTPUT [--algorithm atomic] [--sigma 0.8]
        [--k 300] [--min-size 100] [--hierarchy-level N] [--labels-out F]
        [--time] [--device cuda:0]

The flags are the reference's, plus `--device`: the run takes cuda:0 and
raises without a CUDA device unless `--device cpu` is given. The default
algorithm is "atomic", as in the reference. With --hierarchy-level N > 0 the N-th Boruvka-round label map
is rendered (the reference's benchmark level is 4); with --hierarchy-dir
DIR every level is written, like the reference's per-level output images
(Report.pdf p.4 §3.2.3). Colours come from `colorize` (a seeded
torch.Generator), so they differ from the reference's; the labels do not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from .config import ALGORITHMS

    p = argparse.ArgumentParser(
        prog="gseg_tpu_torch",
        description="graph-based image segmentation on a CUDA device "
                    "(PyTorch port of gseg_tpu)",
    )
    p.add_argument("input", help="input image (ppm/pgm or anything PIL reads)")
    p.add_argument("output", help="output rendering (colorized segmentation)")
    p.add_argument("--algorithm", default="atomic", choices=list(ALGORITHMS),
                   help="segmentation path (default atomic, as in the "
                        "reference's CLI)")
    p.add_argument("--sigma", type=float, default=0.8)
    p.add_argument("--k", type=float, default=300.0)
    p.add_argument("--min-size", type=int, default=100)
    p.add_argument("--max-iters", type=int, default=32)
    p.add_argument("--connectivity", type=int, default=8, choices=(4, 8))
    p.add_argument("--quantize-weight-bits", type=int, default=0)
    p.add_argument("--weight-buckets", type=int, default=0,
                   help="quality mode: ramp edge eligibility through N "
                        "weight-quantile buckets (Kruskal-like ordering; "
                        "16 recovers CPU-baseline ASA)")
    p.add_argument("--hierarchy-level", type=int, default=0,
                   help="render this Boruvka-round level instead of the final map")
    p.add_argument("--hierarchy-dir", default=None,
                   help="write every hierarchy level image into this directory")
    p.add_argument("--labels-out", default=None,
                   help="also save raw int32 labels as .npy")
    p.add_argument("--seed", type=int, default=0, help="coloring seed")
    p.add_argument("--time", action="store_true",
                   help="print phase timings as one JSON line")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0; raises "
                        "without a CUDA device unless this is 'cpu')")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from . import _device, segment, segment_hierarchy
    from .config import SegmentationConfig
    from .utils import image_io
    from .utils.labels import (colorize, colorize_hierarchy,
                               compact_labels_np, num_components)

    cfg = SegmentationConfig(
        sigma=args.sigma,
        k=args.k,
        min_size=args.min_size,
        max_iters=args.max_iters,
        algorithm=args.algorithm,
        connectivity=args.connectivity,
        quantize_weight_bits=args.quantize_weight_bits,
        hierarchy_levels=args.hierarchy_level,
        weight_buckets=args.weight_buckets,
    )
    device = _device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    img = image_io.read_image(args.input)
    t_load = time.perf_counter() - t0

    want_hier = args.hierarchy_level > 0 or args.hierarchy_dir
    t0 = time.perf_counter()
    if want_hier:
        levels, labels = segment_hierarchy(img, config=cfg, device=device)
        if args.hierarchy_level > 0:
            labels = levels[min(args.hierarchy_level, levels.shape[0] - 1)]
    else:
        labels = segment(img, config=cfg, device=device)
    sync()
    t_seg = time.perf_counter() - t0

    t0 = time.perf_counter()
    image_io.write_image(args.output,
                         colorize(labels, args.seed).cpu().numpy())
    if args.hierarchy_dir:
        os.makedirs(args.hierarchy_dir, exist_ok=True)
        base, ext = os.path.splitext(os.path.basename(args.output))
        ext = ext or ".ppm"
        coloured = colorize_hierarchy(levels, args.seed).cpu().numpy()
        for i in range(coloured.shape[0]):
            image_io.write_image(
                os.path.join(args.hierarchy_dir, f"{base}_level{i:02d}{ext}"),
                coloured[i],
            )
    host = labels.cpu().numpy()
    if args.labels_out:
        np.save(args.labels_out, compact_labels_np(host))
    t_out = time.perf_counter() - t0

    if args.time:
        print(json.dumps({
            "algorithm": args.algorithm,
            "shape": list(img.shape),
            "components": num_components(host),
            "load_s": round(t_load, 4),
            "segment_s": round(t_seg, 4),
            "output_s": round(t_out, 4),
        }))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
