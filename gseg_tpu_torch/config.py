"""Segmentation configuration (PyTorch port of `gseg_tpu.config`).

The same frozen dataclass with the same fields and validation, so a
reference configuration converts with
`SegmentationConfig(**dataclasses.asdict(reference_cfg))`, and the same
defaults: `algorithm` is "atomic", as in the reference.
"""

from __future__ import annotations

import dataclasses


ALGORITHMS = (
    "turbo",            # staged gossip + compact-graph path (ported)
    "atomic",           # scatter-min Boruvka-Felzenszwalb (ported; the
                        # default)
    "atomic_hostsync",  # same, host-synced convergence flag (ported: the
                        # same host loop as "atomic")
    "fastmst",          # DPP/FastMST path (ported)
    "superpixel",       # superpixel hierarchy (ported)
    "kruskal_cpu",      # sequential Felzenszwalb oracle (ported, NumPy)
    "boruvka_cpu",      # sequential Boruvka oracle (ported, NumPy)
    "kruskal_native",   # C++ Felzenszwalb baseline (ported: the
                        # reference's felz.cpp, built with g++)
)


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Parameters shared by every algorithm variant.

    sigma:      Gaussian pre-smoothing std-dev.
    k:          Felzenszwalb threshold constant (tau(C) = k / |C|).
    min_size:   minimum component size enforced in a post-pass.
    max_iters:  cap on Boruvka outer iterations.
    algorithm:  one of ALGORITHMS.
    hierarchy_levels: number of per-iteration label maps to record.
    quantize_weight_bits: 0 = full float32 edge weights; 8/10/12/16 quantize
                them as the reference's packed sort keys do.
    connectivity: 8 (E, S, SE, NE canonical directions) or 4 (E, S).
    weight_buckets: 0 = plain Boruvka rounds; N > 0 = quality mode.
    on_overflow: what the checked turbo entry does on a capacity or
                sweep-budget flag: "raise", "fallback" or "ignore".
    """

    sigma: float = 0.8
    k: float = 300.0
    min_size: int = 100
    max_iters: int = 32
    algorithm: str = "atomic"
    hierarchy_levels: int = 0
    quantize_weight_bits: int = 0
    connectivity: int = 8
    weight_buckets: int = 0
    on_overflow: str = "raise"

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; expected one of {ALGORITHMS}"
            )
        if self.connectivity not in (4, 8):
            raise ValueError("connectivity must be 4 or 8")
        if self.quantize_weight_bits not in (0, 8, 10, 12, 16):
            raise ValueError("quantize_weight_bits must be 0/8/10/12/16")
        if self.on_overflow not in ("raise", "fallback", "ignore"):
            raise ValueError("on_overflow must be raise/fallback/ignore")
