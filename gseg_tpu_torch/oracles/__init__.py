"""Oracle partitions committed with the port, and the recipe that makes them.

Each oracle is the canonical partition (`canonical_min_labels_np`) that
`models.boruvka_cpu.segment_boruvka_np` gives for a synthetic image at the
benchmark configuration of `scripts/precompute_oracles.py`: sigma 0.8, k 300,
min_size 100, max_iters 32, `blobs_image(h, w, max(8, h * w // 65536), 8.0,
0)`. It is saved with `np.savez_compressed` under the key "labels".

Remake the committed files (about 75 s at 4K on one CPU core), or only
the named ones:
    python -m gseg_tpu_torch.oracles [name ...]

Level oracles hold, for each level of a segmentation hierarchy, the
component count and the sha256 of the canonical map (int32, C order), as
JSON. They come from the reference's own hierarchies (turbo and atomic;
with `--dpp`, fastmst and superpixel, one record each), run with jax on
the CPU without their outer jit, so the filter chain runs op by op,
bit-equal to the NumPy spec's and the port's weights
(`tests/make_level_oracles.py` remakes them; under jit the reference's
weights drift in the last bits and its early levels differ, PERF.md §7).
"""

from __future__ import annotations

import json
import os

import numpy as np

# name -> (h, w, weight_buckets)
ORACLES = {
    "blobs_2160x3840_wb16": (2160, 3840, 16),
    # the resolution ladder's rungs that bench_out/ holds no oracle for
    "blobs_540x960_wb0": (540, 960, 0),
    "blobs_720x1280_wb0": (720, 1280, 0),
    "blobs_1440x2560_wb0": (1440, 2560, 0),
}


# name -> the hierarchy run it records
LEVEL_ORACLES = {
    "levels_blobs_1080x1920_wb0": {
        "image": (1080, 1920, 31),  # blobs_image(h, w, blobs, 8.0, 0)
        "config": dict(sigma=0.8, k=300.0, min_size=100, max_iters=32),
        "gossip_rounds": 2,
        "oracle": "bench_out/oracle_bench_1080x1920_wb0.npy",
    },
    # {"fastmst": {"levels", "final", "final_raw_sha256"},
    #  "superpixel": {"levels"}}
    "levels_dpp_blobs_1080x1920": {
        "image": (1080, 1920, 31),
        "config": dict(sigma=0.8, k=300.0, min_size=100, max_iters=32),
        "oracle": "bench_out/oracle_bench_1080x1920_wb0.npy",
    },
}


def level_oracle_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.json")


def load_level_oracle(name: str) -> dict:
    """The JSON record of a level oracle: {"levels": [{"components",
    "sha256"}, ...], "final": {...}, ...}, or for the DPP paths one such
    record per path (LEVEL_ORACLES)."""
    with open(level_oracle_path(name)) as f:
        return json.load(f)


def oracle_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.npz")


def load_oracle(path) -> np.ndarray:
    """The (H, W) int32 canonical labels of a committed oracle: an `.npz`
    written here, or a bare `.npy` array as `bench_out/` holds them."""
    data = np.load(path)
    if isinstance(data, np.ndarray):
        return data
    with data:
        return data["labels"]


def make_oracle(name: str) -> np.ndarray:
    """Recompute an oracle's canonical labels with the port's NumPy Boruvka."""
    from ..config import SegmentationConfig
    from ..models.boruvka_cpu import segment_boruvka_np
    from ..utils.labels import canonical_min_labels_np
    from ..utils.synthetic import blobs_image

    h, w, wb = ORACLES[name]
    img = blobs_image(h, w, num_blobs=max(8, (h * w) // 65536), noise=8.0,
                      seed=0)
    cfg = SegmentationConfig(sigma=0.8, k=300.0, min_size=100, max_iters=32,
                             weight_buckets=wb)
    return canonical_min_labels_np(segment_boruvka_np(img, cfg))
