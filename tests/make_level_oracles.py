"""Remake the committed per-level oracle of the 1080p hierarchy (a script,
not a test; about 70 s on one CPU core):

    JAX_PLATFORMS=cpu python tests/make_level_oracles.py

It runs `gseg_tpu`'s turbo hierarchy (`segment_turbo_hierarchy_impl`) and
atomic hierarchy (`segment_atomic_hierarchy`) on the CPU on
`blobs_image(1080, 1920, 31, 8.0, 0)` at sigma 0.8, k 300, min_size 100,
max_iters 32, gossip_rounds 2. Both are called without their outer
`jax.jit`, so the smoothing and the edge weights run op by op: then they
are bit-equal to the reference's NumPy spec (`boruvka_cpu`) and to the
port's, and the rounds run on the weights every other implementation
uses. The script requires the turbo flags to be 0, the two hierarchies'
canonical partitions to agree at every level and both final maps to
equal the committed oracle (`bench_out/oracle_bench_1080x1920_wb0.npy`).
For each level it writes the component count and the sha256 of the
canonical map (int32, C order) to
`gseg_tpu_torch/oracles/levels_blobs_1080x1920_wb0.json`, then prints each
run's seconds and the file's sha256. Exits 1 when a check fails.

It also reports, without failing on it, how the jitted entry
(`segment_turbo_hierarchy_flagged`) differs: under jit, XLA fuses the
filter chain, its smoothed values and weights differ in the last bits,
and near-tie merges of the early rounds come out otherwise. With
`--numpy-specs` (about 2 more minutes) it also holds the levels of the
reference's NumPy specs (`segment_boruvka_np` and `segment_fastmst_np`,
return_levels=True) against the ones it wrote.

With `--dpp` (about 4 minutes) it makes the level oracle of the two DPP
paths instead, and leaves the file above as it is:

    JAX_PLATFORMS=cpu python tests/make_level_oracles.py --dpp

It runs `gseg_tpu`'s `segment_fastmst_hierarchy_impl` and
`segment_superpixel_hierarchy_impl` without their outer `jax.jit` on the
same image and configuration (the compact rounds inside their loops are
compiled, as in any run of the reference), requires flags 0 from both and
the fastmst final partition equal to the committed oracle, and writes each
plane's component count and canonical sha256 (34 fastmst planes, 33
superpixel planes) and the fastmst final labels' raw sha256 (hook-sink
root ids, int32, C order) to
`gseg_tpu_torch/oracles/levels_dpp_blobs_1080x1920.json`. It reports,
without failing on it, how the planes of the reference's NumPy spec
`superpixel_hierarchy_np` (float64 colour sums) differ from the model's.

With `--shape HxW` the --dpp mode runs the ladder's image at that rung
(`blobs_image(h, w, max(8, h * w // 65536), 8.0, 0)`), holds the fastmst
final partition against the rung's committed oracle and writes
`gseg_tpu_torch/oracles/levels_dpp_blobs_<h>x<w>.json`; 540x960 (about
1 minute) and 720x1280 (about 2) have one each, the superpixel ladder's
oracle at those rungs (its final map is level 4):

    JAX_PLATFORMS=cpu python tests/make_level_oracles.py --dpp --shape 540x960
"""

import hashlib
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gseg_tpu.config import SegmentationConfig  # noqa: E402
from gseg_tpu.models.atomic_boruvka import segment_atomic_hierarchy  # noqa: E402,E501
from gseg_tpu.models.boruvka_cpu import (  # noqa: E402
    edge_weight_planes_np, gaussian_smooth_np, segment_boruvka_np)
from gseg_tpu.models.fastmst import segment_fastmst_hierarchy_impl  # noqa: E402,E501
from gseg_tpu.models.fastmst_np import (  # noqa: E402
    segment_fastmst_np, superpixel_hierarchy_np)
from gseg_tpu.models.superpixel import (  # noqa: E402
    segment_superpixel_hierarchy_impl)
from gseg_tpu.models.turbo import (  # noqa: E402
    segment_turbo_hierarchy_flagged, segment_turbo_hierarchy_impl)
from gseg_tpu.ops import filters, grid_graph  # noqa: E402
from gseg_tpu.utils.labels import canonical_min_labels_np  # noqa: E402
from gseg_tpu.utils.synthetic import blobs_image  # noqa: E402
from gseg_tpu_torch.oracles import LEVEL_ORACLES, level_oracle_path  # noqa: E402,E501

NAME = "levels_blobs_1080x1920_wb0"
DPP = "levels_dpp_blobs_1080x1920"


def _entry(canonical):
    return {"components": int(np.unique(canonical).size),
            "sha256": hashlib.sha256(
                np.ascontiguousarray(canonical, np.int32).tobytes()
            ).hexdigest()}


def _weights(img, sigma, jit):
    def f(x):
        smoothed = filters.gaussian_smooth(x, sigma)
        return grid_graph.edge_weight_planes(smoothed)[0]
    return np.asarray((jax.jit(f) if jit else f)(jnp.asarray(img)))


def _differ(a, b):
    return int((~((a == b) | (np.isinf(a) & np.isinf(b)))).sum())


def _write(name, record):
    path = pathlib.Path(level_oracle_path(name))
    path.write_text(json.dumps(record, indent=1) + "\n")
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    print(f"{path.relative_to(ROOT)}: file sha256 {digest}", flush=True)


def _shape_arg():
    """The --shape HxW argument's level oracle name (default 1080p's)."""
    args = sys.argv[1:]
    if "--shape" not in args:
        return DPP
    return f"levels_dpp_blobs_{args[args.index('--shape') + 1]}"


def _load_labels(path):
    data = np.load(path)
    if isinstance(data, np.ndarray):
        return data
    with data:
        return data["labels"]


def dpp_main() -> int:
    """The --dpp mode (module note)."""
    name = _shape_arg()
    spec = LEVEL_ORACLES[name]
    h, w, blobs = spec["image"]
    cfg = SegmentationConfig(**spec["config"])
    img_np = blobs_image(h, w, blobs, 8.0, 0)
    img = jnp.asarray(img_np)
    ok = True
    t0 = time.perf_counter()
    f_levels, f_labels, f_flags = segment_fastmst_hierarchy_impl(img, cfg)
    f_levels, f_labels = np.asarray(f_levels), np.asarray(f_labels)
    print(f"fastmst hierarchy {time.perf_counter() - t0:.1f} s (flags "
          f"{int(f_flags)}), {f_levels.shape[0]} planes", flush=True)
    t0 = time.perf_counter()
    s_levels, _, s_flags = segment_superpixel_hierarchy_impl(img, cfg)
    s_levels = np.asarray(s_levels)
    print(f"superpixel hierarchy {time.perf_counter() - t0:.1f} s (flags "
          f"{int(s_flags)}), {s_levels.shape[0]} planes", flush=True)
    oracle = _load_labels(ROOT / spec["oracle"])
    nd = int((canonical_min_labels_np(f_labels) != oracle).sum())
    print(f"fastmst final labels: {nd} pixels off the oracle", flush=True)
    ok = int(f_flags) == 0 and int(s_flags) == 0 and nd == 0
    fast = [_entry(canonical_min_labels_np(lv)) for lv in f_levels]
    sp = [_entry(canonical_min_labels_np(lv)) for lv in s_levels]
    print(f"components: fastmst {[e['components'] for e in fast]}, "
          f"superpixel {[e['components'] for e in sp]}", flush=True)
    if not ok:
        return 1
    _write(name, {
        "image": f"blobs_image({h}, {w}, {blobs}, 8.0, 0)",
        "config": spec["config"],
        "canonical": "canonical_min_labels_np, int32, C order",
        "fastmst": {"levels": fast, "final": _entry(oracle),
                    "final_raw_sha256": hashlib.sha256(
                        np.ascontiguousarray(f_labels, np.int32).tobytes()
                    ).hexdigest()},
        "superpixel": {"levels": sp}})

    t0 = time.perf_counter()
    np_levels, _ = superpixel_hierarchy_np(img_np, cfg)
    print(f"superpixel_hierarchy_np {time.perf_counter() - t0:.1f} s, "
          f"{np_levels.shape[0]} planes", flush=True)
    for i in range(min(len(np_levels), len(s_levels))):
        a = canonical_min_labels_np(np_levels[i])
        b = canonical_min_labels_np(s_levels[i])
        print(f"  plane {i}: NumPy spec {np.unique(a).size} components, "
              f"model {np.unique(b).size}, {int((a != b).sum())} pixels "
              "differ", flush=True)
    return 0


def main() -> int:
    if "--dpp" in sys.argv[1:]:
        return dpp_main()
    spec = LEVEL_ORACLES[NAME]
    h, w, blobs = spec["image"]
    cfg = SegmentationConfig(**spec["config"])
    rounds = spec["gossip_rounds"]
    img_np = blobs_image(h, w, blobs, 8.0, 0)
    img = jnp.asarray(img_np)
    w_np = edge_weight_planes_np(gaussian_smooth_np(img_np, cfg.sigma))[0]
    eager, jitted = (_weights(img_np, cfg.sigma, j) for j in (False, True))
    print(f"edge weights differing from the NumPy spec's, of {w_np.size}: "
          f"op by op {_differ(eager, w_np)}, under jit "
          f"{_differ(jitted, w_np)}", flush=True)
    ok = _differ(eager, w_np) == 0

    t0 = time.perf_counter()
    t_levels, t_labels, flags = segment_turbo_hierarchy_impl(img, cfg, rounds)
    t_levels, t_labels = np.asarray(t_levels), np.asarray(t_labels)
    t_turbo = time.perf_counter() - t0
    t0 = time.perf_counter()
    a_levels, a_labels = segment_atomic_hierarchy.__wrapped__(img, cfg)
    a_levels, a_labels = np.asarray(a_levels), np.asarray(a_labels)
    t_atomic = time.perf_counter() - t0
    print(f"turbo hierarchy {t_turbo:.1f} s (flags {int(flags)}), atomic "
          f"hierarchy {t_atomic:.1f} s", flush=True)
    ok = ok and int(flags) == 0 and t_levels.shape == a_levels.shape
    levels = []
    for i, (t, a) in enumerate(zip(t_levels, a_levels)):
        ct, ca = canonical_min_labels_np(t), canonical_min_labels_np(a)
        ndiff = int((ct != ca).sum())
        if ndiff:
            print(f"level {i}: {np.unique(ct).size} vs {np.unique(ca).size} "
                  f"components, {ndiff} pixels differ")
            ok = False
        levels.append(_entry(ct))
    oracle = np.load(ROOT / spec["oracle"])
    for side, labels in (("turbo", t_labels), ("atomic", a_labels)):
        nd = int((canonical_min_labels_np(labels) != oracle).sum())
        if nd:
            print(f"{side} final labels: {nd} pixels off the oracle")
            ok = False
    if not ok:
        return 1
    path = pathlib.Path(level_oracle_path(NAME))
    path.write_text(json.dumps({
        "image": f"blobs_image({h}, {w}, {blobs}, 8.0, 0)",
        "config": spec["config"], "gossip_rounds": rounds,
        "canonical": "canonical_min_labels_np, int32, C order",
        "levels": levels, "final": _entry(oracle)}, indent=1) + "\n")
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    print(f"{path.relative_to(ROOT)}: {len(levels)} levels, "
          f"{levels[-1]['components']} components at the last, file sha256 "
          f"{digest}", flush=True)

    t0 = time.perf_counter()
    j_levels, j_labels, j_flags = segment_turbo_hierarchy_flagged(img, cfg,
                                                                  rounds)
    j_levels = np.asarray(j_levels)
    print(f"jitted turbo hierarchy {time.perf_counter() - t0:.1f} s (flags "
          f"{int(j_flags)}); final labels equal: "
          f"{np.array_equal(np.asarray(j_labels), t_labels)}")
    for i, (j, ref) in enumerate(zip(j_levels, levels)):
        e = _entry(canonical_min_labels_np(j))
        if e != ref:
            print(f"  jitted level {i}: {e['components']} components, "
                  f"{ref['components']} op by op")
    if "--numpy-specs" in sys.argv[1:]:
        specs = {
            "segment_boruvka_np": lambda: segment_boruvka_np(
                img_np, cfg, return_levels=True)[1],
            "segment_fastmst_np": lambda: segment_fastmst_np(
                img_np, cfg, return_levels=True)[0]}
        for name, run in specs.items():
            t0 = time.perf_counter()
            got = [_entry(canonical_min_labels_np(lv)) for lv in run()]
            same = [i for i, (e, ref) in enumerate(zip(got, levels))
                    if e == ref]
            print(f"{name} ({time.perf_counter() - t0:.1f} s): {len(got)} "
                  f"levels, equal to the written ones at {same}; components "
                  f"{[e['components'] for e in got]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
