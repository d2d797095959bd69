"""The one traffic generator: a mix's file of parameters -> a pool of
distinct frames made from the seed, which a closed loop cycles through.

A mix names its `content` (one of CONTENT), the frame's `height` and
`width`, the content's own parameters and the `pool` size, besides how it
is offered (`loop`, `callers`, which the harness reads). Each frame of
the pool has a seed of its own, drawn from the run's seed, so the same
seed gives the same frames; the pool's sizes are the same for every
seed. A key that the generator does not read is refused, so that a mix
never measures something other than what its file says."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import synthetic

# content -> (its own parameters, the frame of a mix and a seed)
CONTENT = {
    "blobs": (("num_blobs", "noise"), lambda t, s: synthetic.blobs_image(
        t["height"], t["width"], t["num_blobs"], t["noise"], s)),
    "bsds_like": (("n_regions",), lambda t, s: synthetic.bsds_like_image(
        t["height"], t["width"], t["n_regions"], s)),
    "textured": ((), lambda t, s: synthetic.textured_image(
        t["height"], t["width"], s)),
}
# every mix's keys besides its content's parameters
COMMON = ("name", "source", "loop", "callers", "content", "height", "width",
          "pool")


def check_traffic(traffic: dict) -> None:
    """Refuses a mix whose content or keys the generator does not know."""
    if traffic.get("content") not in CONTENT:
        raise ValueError(f"traffic {traffic.get('name')!r}: content "
                         f"{traffic.get('content')!r} is not one of "
                         f"{sorted(CONTENT)}")
    known = set(COMMON) | set(CONTENT[traffic["content"]][0])
    unknown = sorted(set(traffic) - known)
    if unknown:
        raise ValueError(f"traffic {traffic.get('name')!r}: the generator "
                         f"reads no key {unknown}")


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """A stream of draws from the run's seed: any whole number (negative
    ones and ones past 64 bits too), one stream per use."""
    return np.random.SeedSequence([seed % (1 << 64), seed >> 64 & 0xFFFF,
                                   stream])


def frame_seeds(seed: int, n: int) -> list[int]:
    return [int(s) for s in seed_sequence(seed, 0).generate_state(n)]


def make_pool(traffic: dict, seed: int) -> list[np.ndarray]:
    """The mix's pool of (height, width, 3) uint8 frames, made on a few
    threads (NumPy's array work releases the interpreter's lock); each
    frame depends on its own seed alone."""
    check_traffic(traffic)
    make = CONTENT[traffic["content"]][1]
    seeds = frame_seeds(seed, traffic["pool"])
    with ThreadPoolExecutor(min(len(seeds), os.cpu_count() or 1)) as pool:
        return [np.ascontiguousarray(f) for f in
                pool.map(lambda s: make(traffic, s), seeds)]
