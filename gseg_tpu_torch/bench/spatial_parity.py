"""Bench-scale multi-device parity: the row-sharded turbo path against the
dense one (port of `scripts/spatial_parity_540p.py`).

Multi-device equality tests run at toy shapes; this runs
`parallel.turbo_spatial.segment_turbo_spatial` at real ladder rungs, on
blobs and textured content, in speed and quality mode (`weight_buckets` 0
and 16, k 300, min_size 100), and requires its canonical partition to be
the dense `segment_turbo_flagged`'s, with flags 0 on both. The plan is the
reference's: 540p on 4 ranks (540 rows do not split 8 ways) and 720p on 8.

The ranks share cuda:0 (one thread each, as `spatial_mesh(["cuda:0"] * n)`
gives them); with --cards rank i takes card i (modulo the card count).
--device cpu runs the dense path and every rank on the CPU; without a card
and without --device it raises. It writes
`bench_out/torch/spatial_parity.json` (rows with the reference's keys:
content, h, w, n_dev, weight_buckets, equal, dense_flags, spatial_flags,
dense_s, spatial_s), prints one RESULT line a row, and exits 1 on any
mismatch or flag, else 0.

Usage: python -m gseg_tpu_torch.bench.spatial_parity [--shape HxWxN ...]
       [--cards | --device cuda:0|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import SegmentationConfig
from ..models.turbo import segment_turbo_flagged
from ..parallel.spatial import spatial_mesh
from ..parallel.turbo_spatial import segment_turbo_spatial
from ..utils.labels import canonical_min_labels_np
from .harness import ladder_image

PLAN = ((540, 960, 4), (720, 1280, 8))
CONTENTS = ("blobs", "textured")
WEIGHT_BUCKETS = (0, 16)
GOSSIP_ROUNDS = 2
OUT = os.path.join("bench_out", "torch", "spatial_parity.json")


def config(weight_buckets: int) -> SegmentationConfig:
    return SegmentationConfig(k=300.0, min_size=100,
                              weight_buckets=weight_buckets)


def rank_devices(n_dev: int, device: torch.device, cards: bool) -> list:
    """The devices of n_dev ranks: all `device`, or with `cards` one card
    each (rank i on card i modulo the card count)."""
    if cards:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("--cards: no CUDA device is available")
        return [torch.device("cuda", i % count) for i in range(n_dev)]
    return [device] * n_dev


def _timed_labels(fn):
    t0 = time.perf_counter()
    labels, flags = fn()
    labels = canonical_min_labels_np(labels.cpu().numpy())
    return labels, int(flags), time.perf_counter() - t0


def run_row(content: str, h: int, w: int, devices: list, weight_buckets: int,
            device: torch.device) -> dict:
    """One row: the dense path on `device`, then the row-sharded path over
    `devices`, each timed once on the host clock (canonicalisation
    included, as the reference times it)."""
    cfg = config(weight_buckets)
    image = torch.from_numpy(ladder_image(h, w, content)).to(device)
    mesh = spatial_mesh(devices)
    dense, dflags, dense_s = _timed_labels(
        lambda: segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS))
    sp, sflags, spatial_s = _timed_labels(
        lambda: segment_turbo_spatial(image, cfg, mesh, "space",
                                      GOSSIP_ROUNDS))
    return {"content": content, "h": h, "w": w, "n_dev": len(devices),
            "weight_buckets": weight_buckets,
            "equal": bool(np.array_equal(dense, sp)),
            "dense_flags": dflags, "spatial_flags": sflags,
            "dense_s": round(dense_s, 3), "spatial_s": round(spatial_s, 3)}


def row_ok(row: dict) -> bool:
    return row["equal"] and row["dense_flags"] == row["spatial_flags"] == 0


def _shape(text: str):
    h, w, n = (int(t) for t in text.split("x"))
    return h, w, n


def main(argv=None) -> int:
    from .. import _device

    ap = argparse.ArgumentParser(prog="gseg_tpu_torch.bench.spatial_parity")
    ap.add_argument("--shape", type=_shape, action="append",
                    help="HxWxN: run this shape on N ranks in place of the "
                         "plan (540x960x4, 720x1280x8); repeatable")
    ap.add_argument("--cards", action="store_true",
                    help="one card a rank (card i for rank i, modulo the "
                         "card count) in place of every rank on cuda:0")
    ap.add_argument("--device", default=None,
                    help="torch device of the dense path and the ranks "
                         "(default cuda:0; raises without a CUDA device "
                         "unless this is 'cpu')")
    ap.add_argument("--out", default=OUT,
                    help=f"the JSON record (default {OUT})")
    args = ap.parse_args(argv)
    device = _device("cuda:0" if args.cards else args.device)
    rows = []
    for h, w, n_dev in args.shape or PLAN:
        devices = rank_devices(n_dev, device, args.cards)
        for content in CONTENTS:
            for wb in WEIGHT_BUCKETS:
                row = run_row(content, h, w, devices, wb, device)
                rows.append(row)
                print("RESULT", json.dumps(row), flush=True)
    ok = all(row_ok(r) for r in rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    where = "one card each" if args.cards else str(device)
    if device.type == "cuda":
        where += f" ({torch.cuda.get_device_name(device)})"
    with open(args.out, "w") as f:
        json.dump({"mesh": f"ranks on {where}", "rows": rows, "ok": ok}, f,
                  indent=1)
    print("OK" if ok else "MISMATCH", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
