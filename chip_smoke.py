"""Drive the PyTorch port's main path once on a CUDA card and check it.

Run from the repository root: `python3 chip_smoke.py` (one card, no
arguments). It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from `gseg_tpu_torch/csrc/` (nvcc, sm_90a);
  3. holds every kernel against its plain PyTorch version on the same CUDA
     tensors (random fields at odd multi-tile shapes, then the 1080p fields
     captured from the main path); the fixpoints must be bit-equal and the
     extraction pool equal as a sorted multiset;
  4. runs `segment_turbo_flagged` at 1080x1920 on blobs_image(1080, 1920,
     31, 8.0, 0) with sigma 0.8, k 300, min_size 100, max_iters 32 and
     gossip_rounds 2, and requires flags == 0, the canonical partition of
     bench_out/oracle_bench_1080x1920_wb0.npy, and at least one launch of
     each kernel in that run;
  5. times the main path (median of 5 reps, CUDA events, after a warm-up),
     its stages, and each kernel beside its plain version at 1080p.

Every failure propagates and the script exits non-zero. The last two lines
are a JSON record of the kernels and `{"ok": true, "device": {...}}`.
There is no CPU path.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gseg_tpu_torch.config import SegmentationConfig
from gseg_tpu_torch.models import turbo
from gseg_tpu_torch.ops import filters
from gseg_tpu_torch.ops import grid_graph as gg
from gseg_tpu_torch.ops.kernels import _build
from gseg_tpu_torch.ops.kernels import extract as kx
from gseg_tpu_torch.ops.kernels import gossip as kg
from gseg_tpu_torch.utils.labels import canonical_min_labels_np
from gseg_tpu_torch.utils.synthetic import blobs_image

ROOT = Path(__file__).resolve().parent
ORACLE = ROOT / "bench_out" / "oracle_bench_1080x1920_wb0.npy"
H, W = 1080, 1920
CFG = SegmentationConfig(sigma=0.8, k=300.0, min_size=100, max_iters=32,
                         algorithm="turbo")
GOSSIP_ROUNDS = 2

# name -> (wrapper, plain version, CUDA source, TPU kernel it replaces)
KERNELS = {
    "gossip_compmin": (
        "compmin_gossip", kg.compmin_gossip_plain,
        "gseg_tpu_torch/csrc/gossip.cu",
        "gseg_tpu/ops/pallas/gossip.py:386 (_strip_call_skip, "
        "_compmin_step :997)"),
    "gossip_labelnd": (
        "label_flood", kg.label_flood_plain,
        "gseg_tpu_torch/csrc/gossip.cu",
        "gseg_tpu/ops/pallas/gossip.py:386 (_strip_call_skip, "
        "_labelnd_step :1086)"),
    "gossip_value": (
        "value_flood", kg.value_flood_plain,
        "gseg_tpu_torch/csrc/gossip.cu",
        "gseg_tpu/ops/pallas/gossip.py:386 (_strip_call_skip, "
        "_value_step :1120)"),
    "boundary_extract": (
        "boundary_extract", kx.boundary_extract_plain,
        "gseg_tpu_torch/csrc/extract.cu",
        "gseg_tpu/ops/pallas/extract.py:344 (_extract_kernel, via "
        "boundary_extract :515)"),
}


def _module(name):
    return kx if name == "boundary_extract" else kg


def _wrapper(name):
    return getattr(_module(name), KERNELS[name][0])


def _counts():
    return {name: _wrapper(name).launches for name in KERNELS}


def _reset_counts():
    for name in KERNELS:
        _wrapper(name).launches = 0


def _cuda_ms(fn, reps):
    """Median milliseconds of `reps` calls, CUDA events, after one warm-up
    call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_abs_err(a, b):
    """Max |a - b| over matching field tuples (tensors compared in float64);
    raises if shapes differ."""
    err = 0.0
    for x, y in zip(a, b):
        if not isinstance(x, torch.Tensor):
            continue
        if x.shape != y.shape:
            raise AssertionError(f"shape mismatch {x.shape} vs {y.shape}")
        if x.numel():
            d = (x.double() - y.double()).abs()
            d = torch.where(torch.isnan(d), 0.0, d)  # inf - inf in equal slots
            err = max(err, float(d.max()))
        if not torch.equal(x, y):
            raise AssertionError("kernel and plain version differ "
                                 f"(max abs err {err})")
    return err


def _pool_multiset(res):
    lo, hi, wv, eid, count, ovf = res
    if bool(ovf):
        raise AssertionError("extraction pool overflowed in a comparison")
    n = int(count)
    keys = torch.stack([lo[:n].double(), hi[:n].double(), wv[:n].double(),
                        eid[:n].double()], 1).cpu().numpy()
    return [torch.from_numpy(keys[np.lexsort(keys.T[::-1])])]


def _compare(name, args):
    """Run the kernel wrapper and the plain version on the same CUDA
    tensors; returns the max abs error (0.0: equal)."""
    kernel_out = _wrapper(name)(*args)
    plain_out = KERNELS[name][1](*args)
    torch.cuda.synchronize()
    if name == "boundary_extract":
        return _max_abs_err(_pool_multiset(kernel_out),
                            _pool_multiset(plain_out))
    if kernel_out[-1] or plain_out[-1]:
        raise AssertionError(f"{name}: a fixpoint hit its sweep cap")
    return _max_abs_err(kernel_out[:-1], plain_out[:-1])


def _random_args(h, w, dev, seed):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x).to(dev)

    L = t(rng.integers(0, 7, (h, w)).astype(np.int32))
    bw = t(rng.uniform(0, 1, (h, w)).astype(np.float32))
    be = t(rng.integers(0, 10_000, (h, w)).astype(np.int32))
    sz = t(rng.integers(1, 9, (h, w)).astype(np.int32))
    allow = t(rng.integers(0, 256, (h, w)).astype(np.int32))
    weights = rng.uniform(0.5, 9.0, (4, h, w)).astype(np.float32)
    for d, (dy, dx) in enumerate(gg.DIRS4):
        weights[d][~gg.valid_plane(h, w, dy, dx).numpy()] = np.inf
    ms = 4 * (h + w)
    return {
        "gossip_compmin": (L, bw, be, sz, ms),
        "gossip_labelnd": (allow, be, bw, ms),
        "gossip_value": (L, be, ms),
        "boundary_extract": (L, t(weights), 4 * h * w),
    }


def _capture_main_path_fields(image):
    """Run the main path once, recording each wrapper's first real call
    (compmin's first non-idle one). Returns name -> argument tuple."""
    captured = {}
    originals = {name: _wrapper(name) for name in KERNELS}

    def recorder(name):
        fn = originals[name]

        def rec(*args, **kwargs):
            if name not in captured and not kwargs.get("idle", False):
                captured[name] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            return fn(*args, **kwargs)
        return rec

    for name in KERNELS:
        setattr(_module(name), KERNELS[name][0], recorder(name))
    try:
        turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS)
    finally:
        for name, fn in originals.items():
            setattr(_module(name), KERNELS[name][0], fn)
    missing = set(KERNELS) - set(captured)
    if missing:
        raise AssertionError(f"main path never called {sorted(missing)}")
    return captured


def _stage_split(image, reps=3):
    """Median ms of each main-path stage, run in sequence as
    segment_turbo_impl runs them."""
    v = H * W
    out = {}

    def weights():
        sm = filters.gaussian_smooth(image, CFG.sigma)
        return gg.edge_weight_planes(sm, CFG.connectivity,
                                     CFG.quantize_weight_bits)[0]

    wts = weights()
    gst, _ = turbo._stage_g(image, CFG, GOSSIP_ROUNDS, wts)
    st, rm, r0 = turbo._extract_stage(gst, wts)
    st2 = turbo._s2_stage(st, v, CFG)
    out["weights"] = _cuda_ms(weights, reps)
    out["stage_g"] = _cuda_ms(
        lambda: turbo._stage_g(image, CFG, GOSSIP_ROUNDS, wts), reps)
    out["handoff"] = _cuda_ms(lambda: turbo._extract_stage(gst, wts), reps)
    out["stage_2"] = _cuda_ms(lambda: turbo._s2_stage(st, v, CFG), reps)
    out["final_map"] = _cuda_ms(
        lambda: turbo._final_map(gst, st2, rm, r0, 4 * (H + W)), reps)
    out["rounds_stage_g"] = gst.it
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda."
                         "is_available() is False); there is no CPU path")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    card = card.splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    for src in ("gossip", "extract"):
        _build.load(src, verbose=True)
        print(f"build {src}.cu: {_build.build_seconds[src]:.2f} s",
              flush=True)

    errs = {name: 0.0 for name in KERNELS}
    for h, w in ((37, 150), (1081, 1919)):
        for name, args in _random_args(h, w, dev, seed=h * 7 + w).items():
            errs[name] = max(errs[name], _compare(name, args))
            print(f"check {name} {h}x{w}: equal to plain", flush=True)

    image = torch.from_numpy(blobs_image(H, W, 31, 8.0, 0)).to(dev)
    fields = _capture_main_path_fields(image)
    kernel_ms, plain_ms = {}, {}
    for name, args in fields.items():
        errs[name] = max(errs[name], _compare(name, args))
        kernel_ms[name] = _cuda_ms(lambda: _wrapper(name)(*args), 5)
        plain_ms[name] = _cuda_ms(lambda: KERNELS[name][1](*args), 3)
        print(f"check {name} 1080p main-path fields: equal to plain; "
              f"kernel {kernel_ms[name]:.3f} ms, plain {plain_ms[name]:.3f}"
              f" ms ({card})", flush=True)

    # the main path, counted.
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    labels, flags = turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS)
    torch.cuda.synchronize()
    launches = _counts()
    print(f"main path: flags {flags} ({turbo.describe_flags(flags)}), "
          f"launches {launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    if flags != 0:
        raise AssertionError(f"main path raised flags {flags}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    got = canonical_min_labels_np(labels.cpu().numpy())
    oracle = np.load(ORACLE)
    ndiff = int((got != oracle).sum())
    print(f"oracle partition: {ndiff} pixels differ "
          f"({len(np.unique(got))} components, oracle "
          f"{len(np.unique(oracle))})", flush=True)
    if ndiff:
        # tell a filter-drift near-tie apart from a kernel fault
        cpu_w, _ = gg.edge_weight_planes(
            filters.gaussian_smooth(image.cpu(), CFG.sigma),
            CFG.connectivity, CFG.quantize_weight_bits)
        lab2, fl2 = turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS,
                                                weights_override=cpu_w)
        nd2 = int((canonical_min_labels_np(lab2.cpu().numpy())
                   != oracle).sum())
        print(f"rerun with CPU-filter weights: flags {fl2}, {nd2} pixels "
              "differ from the oracle", flush=True)
        raise AssertionError("main path partition differs from the oracle")

    total_ms = _cuda_ms(
        lambda: turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS), 5)
    print(f"main path 1080p: median {total_ms:.3f} ms of 5 reps = "
          f"{H * W / 1e6 / (total_ms / 1e3):.2f} MPix/s ({card})", flush=True)
    split = _stage_split(image)
    print("stage split (median ms of 3): " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in split.items()) + f" ({card})", flush=True)

    if "jax" in sys.modules or any(m.startswith("gseg_tpu.")
                                   for m in sys.modules):
        raise AssertionError("the port imported jax or gseg_tpu")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][2],
         "replaces": KERNELS[name][3], "launches": launches[name],
         "max_abs_err": errs[name], "ms": kernel_ms[name],
         "plain_ms": plain_ms[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke wall time {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
