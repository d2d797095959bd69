"""Oracle partitions committed with the port, and the recipe that makes them.

Each oracle is the canonical partition (`canonical_min_labels_np`) that
`models.boruvka_cpu.segment_boruvka_np` gives for a synthetic image at the
benchmark configuration of `scripts/precompute_oracles.py`: sigma 0.8, k 300,
min_size 100, max_iters 32, the ladder's image (`bench.harness.ladder_image`:
`blobs_image(h, w, max(8, h * w // 65536), 8.0, 0)`, or for textured content
`textured_image(h, w, 0)`). `RECIPES` lists the content, k and min_size of
the oracles that differ from that. It is saved with `np.savez_compressed`
under the key "labels", and `RECORDED` holds each file's component count and
the sha256 of its label bytes.

Remake the committed files (about 75 s at 4K, 70 s at 5K and 190 s at 8K,
whose run peaks at 14.4 GiB of host memory), or only the named ones:
    python -m gseg_tpu_torch.oracles [name ...]

At the bench configuration the textured images segment into one component
(540p, 1080p and 4K): their oracles cannot tell a leaked minimum label
from a right one. `textured_1080x1920_k10_wb16` (k 10, min_size 10, quality
mode) gives 162 components, and is the textured oracle that can fail.

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
    "blobs_2880x5120_wb0": (2880, 5120, 0),
    "blobs_4320x7680_wb0": (4320, 7680, 0),
    # the reference record's quality-mode rung at 540p (bench_out/perf.jsonl)
    "blobs_540x960_wb16": (540, 960, 16),
    # the textured rows of the reference's record (bench_out/perf.jsonl)
    "textured_540x960_wb0": (540, 960, 0),
    "textured_1080x1920_wb0": (1080, 1920, 0),
    "textured_2160x3840_wb0": (2160, 3840, 0),
    "textured_1080x1920_k10_wb16": (1080, 1920, 16),
}

# name -> what differs from the bench recipe (blobs, k 300, min_size 100)
RECIPES = {
    "textured_540x960_wb0": dict(content="textured"),
    "textured_1080x1920_wb0": dict(content="textured"),
    "textured_2160x3840_wb0": dict(content="textured"),
    "textured_1080x1920_k10_wb16": dict(content="textured", k=10.0,
                                        min_size=10),
}

# name -> (components, sha256 of the label bytes), as
# `python -m gseg_tpu_torch.oracles` prints them
RECORDED = {
    "blobs_2160x3840_wb16": (90, "042e7a8b3bb13b5650d1be6c2d556e30"
                                 "ae5a6932abaff7e72c1c149e428db207"),
    "blobs_540x960_wb0": (3, "b77557b1952915b1233dd29591a4f1e6"
                             "ac43857937df55f93ebcfbfa0c1f0827"),
    "blobs_720x1280_wb0": (2, "b4eeb24b8ec2ddc0970abfad252bc044"
                              "6aba15324d8a7ac8dcd6df26cd296c7a"),
    "blobs_1440x2560_wb0": (5, "35b814ba7c68b9d4d5be2e743d6c6131"
                               "c045491bc869d1c9bd0092616cfb86c1"),
    "blobs_2880x5120_wb0": (34, "a7d4920fcb3a55e82e61022475e480ed"
                                "a3ce899bb931fe89c1c00b1a208adc91"),
    "blobs_4320x7680_wb0": (72, "82e21017af455f04562b598b90941e41"
                                "51515e8b558002c6aa9a25dc244cb4a7"),
    "blobs_540x960_wb16": (5, "c67bd73474848b8553edb787ce795cf0"
                              "8b5a538857159b397a200fa614b62c2a"),
    "textured_540x960_wb0": (1, "11283ef755895422e6f28b93f3d78cad"
                                "7539891cf2893c9fdccefb923c5bf70b"),
    "textured_1080x1920_wb0": (1, "788ae0147bdf979a6575938ca2d7d440"
                                  "3788588f7be2010f03776c968fd1ab49"),
    "textured_2160x3840_wb0": (1, "33c9aff6d23026135eadf5cd36f57842"
                                  "20bf77c05ed774e7c186a0f812ba0c7b"),
    "textured_1080x1920_k10_wb16": (162, "e5fd2ff89c9e4dfcc80f9028dd9949a0"
                                         "9e193b68340e8a98b73d5b069ddb197c"),
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
    # the superpixel ladder's lower rungs (their final map is level 4)
    "levels_dpp_blobs_540x960": {
        "image": (540, 960, 8),
        "config": dict(sigma=0.8, k=300.0, min_size=100, max_iters=32),
        "oracle": "gseg_tpu_torch/oracles/blobs_540x960_wb0.npz",
    },
    "levels_dpp_blobs_720x1280": {
        "image": (720, 1280, 14),
        "config": dict(sigma=0.8, k=300.0, min_size=100, max_iters=32),
        "oracle": "gseg_tpu_torch/oracles/blobs_720x1280_wb0.npz",
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


def oracle_recipe(name: str):
    """(content, SegmentationConfig) of an oracle: the image is
    `bench.harness.ladder_image(h, w, content)`."""
    from ..config import SegmentationConfig

    h, w, wb = ORACLES[name]
    spec = dict(content="blobs", k=300.0, min_size=100) | RECIPES.get(name,
                                                                       {})
    cfg = SegmentationConfig(sigma=0.8, k=spec["k"],
                             min_size=spec["min_size"], max_iters=32,
                             weight_buckets=wb)
    return spec["content"], cfg


def make_oracle(name: str) -> np.ndarray:
    """Recompute an oracle's canonical labels with the port's NumPy Boruvka."""
    from ..bench.harness import ladder_image
    from ..models.boruvka_cpu import segment_boruvka_np
    from ..utils.labels import canonical_min_labels_np

    h, w, _ = ORACLES[name]
    content, cfg = oracle_recipe(name)
    return canonical_min_labels_np(segment_boruvka_np(
        ladder_image(h, w, content), cfg))
