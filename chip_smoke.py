"""Drive the PyTorch port's main paths once on a CUDA card and check them.

Run from the repository root: `python3 chip_smoke.py` (one card, no
arguments). It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from `gseg_tpu_torch/csrc/` (one nvcc per
     source, all started together; sm_90a);
  3. holds every kernel against its plain PyTorch version on the same CUDA
     tensors: random fields at odd multi-tile shapes and at wide shapes
     (w >= 2560: the padded fixpoint route), then the fields captured from
     the main paths; fixpoints and pads must be bit-equal, the extraction
     pool equal as a sorted multiset;
  4. runs `segment_turbo_flagged` (sigma 0.8, k 300, min_size 100,
     max_iters 32, gossip_rounds 2) on three main paths, each with the
     launch counts set to 0 just before it and read just after:
       - 1080p, the default configuration (subsum peel rounds):
         blobs_image(1080, 1920, 31, 8.0, 0);
       - 1080p, the count peel (`turbo._PEEL_SIZES = "count"`);
       - 4K, the default configuration: blobs_image(2160, 3840, 126, 8.0, 0);
     and requires flags == 0, the canonical partition of the committed
     oracle (bench_out/oracle_bench_{1080x1920,2160x3840}_wb0.npy), a launch
     of every kernel of that path (pad and unpad only at 4K, where they
     must run, and never at 1080p);
  5. times each path (median of CUDA-event reps after a warm-up), its
     stages, its peak memory, and each kernel beside its plain version and,
     where one exists, a PyTorch call computing the same function; then the
     1080p subsum and count peels in 10 alternating pairs.

Every failure propagates and the script exits non-zero; no kernel falls
back to its plain version and nothing moves to the CPU. The last two lines
are a JSON record of the kernels and `{"ok": true, "device": {...}}`.
There is no CPU path.
"""

from __future__ import annotations

import concurrent.futures
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
from gseg_tpu_torch.ops.kernels import pad as kp
from gseg_tpu_torch.utils.labels import canonical_min_labels_np
from gseg_tpu_torch.utils.synthetic import blobs_image

ROOT = Path(__file__).resolve().parent
CFG = SegmentationConfig(sigma=0.8, k=300.0, min_size=100, max_iters=32,
                         algorithm="turbo")
GOSSIP_ROUNDS = 2
# path name -> (h, w, blobs, peel sizes, oracle)
PATHS = {
    "1080p_subsum": (1080, 1920, 31, "subsum",
                     "bench_out/oracle_bench_1080x1920_wb0.npy"),
    "1080p_count": (1080, 1920, 31, "count",
                    "bench_out/oracle_bench_1080x1920_wb0.npy"),
    "4k_subsum": (2160, 3840, 126, "subsum",
                  "bench_out/oracle_bench_2160x3840_wb0.npy"),
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
_GOSSIP = "gseg_tpu/ops/pallas/gossip.py:386 (_strip_call_skip, "

# name -> (module, wrapper name, plain version, CUDA source, TPU kernel it
# replaces, paths that must launch it, bytes per pixel of one read of every
# input plane and one write of every output plane, operations per pixel)
KERNELS = {
    "gossip_compmin": (
        kg, "compmin_gossip", kg.compmin_gossip_plain,
        "gseg_tpu_torch/csrc/gossip.cu", _GOSSIP + "_compmin_step :997)",
        set(PATHS), 28, 40),
    "gossip_labeldist": (
        kg, "label_gossip", kg.label_gossip_plain,
        "gseg_tpu_torch/csrc/gossip.cu",
        _GOSSIP + "_label_step :1057, via label_gossip :1228)",
        {"1080p_subsum", "4k_subsum"}, 28, 48),
    "gossip_labelnd": (
        kg, "label_flood", kg.label_flood_plain,
        "gseg_tpu_torch/csrc/gossip.cu", _GOSSIP + "_labelnd_step :1086)",
        set(PATHS), 20, 24),
    "gossip_value": (
        kg, "value_flood", kg.value_flood_plain,
        "gseg_tpu_torch/csrc/gossip.cu", _GOSSIP + "_value_step :1120)",
        set(PATHS), 12, 16),
    "gossip_subsum": (
        kg, "subtree_sums", kg.subtree_sums_plain,
        "gseg_tpu_torch/csrc/gossip.cu",
        _GOSSIP + "_subsum_step :1157, via subtree_sums :1320)",
        {"1080p_subsum", "4k_subsum"}, 12, 16),
    "pad_fields": (
        kp, "fast_pad_fields", kp.fast_pad_fields_plain,
        "gseg_tpu_torch/csrc/pad.cu",
        "gseg_tpu/ops/pallas/gossip.py:703 (_fast_pad_fields, call :781)",
        {"4k_subsum"}, None, 0),
    "unpad_fields": (
        kp, "fast_unpad_fields", kp.fast_unpad_fields_plain,
        "gseg_tpu_torch/csrc/pad.cu",
        "gseg_tpu/ops/pallas/gossip.py:799 (_fast_unpad_fields, call :826)",
        {"4k_subsum"}, None, 0),
    "boundary_extract": (
        kx, "boundary_extract", kx.boundary_extract_plain,
        "gseg_tpu_torch/csrc/extract.cu",
        "gseg_tpu/ops/pallas/extract.py:344 (_extract_kernel, via "
        "boundary_extract :515)",
        set(PATHS), 20, 16),
}
PADS = ("pad_fields", "unpad_fields")
# name -> the kernel's symbol as the profiler shows it (demangled)
SYMBOLS = {
    "gossip_compmin": "fixpoint_pass<(anonymous namespace)::CompminOp>",
    "gossip_labeldist": "fixpoint_pass<(anonymous namespace)::LabelDistOp>",
    "gossip_labelnd": "fixpoint_pass<(anonymous namespace)::LabelndOp>",
    "gossip_value": "fixpoint_pass<(anonymous namespace)::ValueOp>",
    "gossip_subsum": "fixpoint_pass<(anonymous namespace)::SubsumOp>",
    "pad_fields": "::pad_fields(",
    "unpad_fields": "::unpad_fields(",
    "boundary_extract": "boundary_extract_kernel",
}


def _wrapper(name):
    mod, attr = KERNELS[name][:2]
    return getattr(mod, attr)


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


def _device_ms(fn, name):
    """Device time (ms) of the kernel's own launches in one call, from
    torch.profiler; None when the trace holds no device time for it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0)
             for e in prof.key_averages() if SYMBOLS[name] in e.key)
    return us / 1e3 if us else None


def _max_abs_err(a, b):
    """Max |a - b| over matching field tuples (tensors compared in float64);
    raises if shapes differ or the tensors are not equal."""
    err = 0.0
    for x, y in zip(a, b, strict=True):
        if not isinstance(x, torch.Tensor):
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/type mismatch {x.shape} {x.dtype} "
                                 f"vs {y.shape} {y.dtype}")
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
    plain_out = KERNELS[name][2](*args)
    torch.cuda.synchronize()
    if name == "boundary_extract":
        return _max_abs_err(_pool_multiset(kernel_out),
                            _pool_multiset(plain_out))
    if name in PADS:
        return _max_abs_err(kernel_out, plain_out)
    if kernel_out[-1] or plain_out[-1]:
        raise AssertionError(f"{name}: a fixpoint hit its sweep cap")
    return _max_abs_err(kernel_out[:-1], plain_out[:-1])


def _library_call(name, args):
    """One PyTorch call per field computing the same function as the
    kernel, where one exists (timed as a yardstick only)."""
    if name == "pad_fields":
        fields, t, hp, wp = args

        def run():
            for x, fill in fields:
                torch.nn.functional.pad(
                    x, (0, wp - x.shape[1], t, hp - x.shape[0] + t),
                    value=fill)
        return run
    if name == "unpad_fields":
        fields, t, h, w = args

        def run():
            for x in fields:
                x[t:t + h, :w].clone()
        return run
    return None


def _bound(name, args):
    """Least time in ms for the card to do one call's work: one read of
    every input and one write of every output at the HBM rate, or the
    operations at the float32 rate, whichever is larger."""
    per_px, ops_px = KERNELS[name][6:8]
    if name == "pad_fields":
        fields, t, hp, wp = args
        nbytes = sum(4 * (x.numel() + (hp + 2 * t) * wp) for x, _ in fields)
        npx = 0
    elif name == "unpad_fields":
        fields, t, h, w = args
        nbytes = 2 * 4 * h * w * len(fields)
        npx = 0
    else:
        npx = args[0].numel()
        nbytes = per_px * npx
        if name == "boundary_extract":
            nbytes += 16 * int(kx.boundary_extract(*args)[4])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_px * npx / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _same_label_pdir(L, seed):
    """BFS levels from sparse random seeds over same-label adjacency (plain
    flood) and the parent directions of that forest: a consistent pdir."""
    h, w = L.shape
    g = torch.Generator(device=L.device).manual_seed(seed)
    seeds = torch.rand((h, w), generator=g, device=L.device) < 0.05
    dist0 = torch.full((h, w), kg.BIGDIST, dtype=torch.int32,
                       device=L.device).masked_fill(seeds, 0)
    same = kg.pack_allow_bits([gg.shift_plane(L, dy, dx, -1) == L
                               for dy, dx in gg.DIRS8])
    _, _, dist, unconv = kg.label_gossip_plain(
        same, L, torch.zeros((h, w), device=L.device), dist0, 4 * (h + w))
    if unconv:
        raise AssertionError("BFS for the subsum check did not converge")
    return dist0, turbo._parent_dirs(L, dist)


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
    dist0, pdir = _same_label_pdir(L, seed)
    ms = 4 * (h + w)
    pad_in = [(L, -1), (bw, float("inf")), (be, kg.INT32_MAX), (allow, 0)]
    hp, wp = -(-h // 32) * 32, -(-w // 128) * 128
    return {
        "gossip_compmin": (L, bw, be, sz, ms),
        "gossip_labeldist": (allow, be, bw, dist0, ms),
        "gossip_labelnd": (allow, be, bw, ms),
        "gossip_value": (L, be, ms),
        "gossip_subsum": (pdir, torch.ones_like(pdir), ms),
        "pad_fields": (pad_in, 8, hp, wp),
        "unpad_fields": (kp.fast_pad_fields_plain(pad_in, 8, hp, wp), 8, h,
                         w),
        "boundary_extract": (L, t(weights), 4 * h * w),
    }


def _clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x) for x in a)
    return a


def _capture_main_path_fields(image):
    """Run the main path once, recording each wrapper's first real call
    (compmin's first non-idle one). Returns name -> argument tuple."""
    captured = {}
    originals = {name: _wrapper(name) for name in KERNELS}

    def recorder(name):
        fn = originals[name]

        def rec(*args, **kwargs):
            if name not in captured and not kwargs.get("idle", False):
                captured[name] = _clone(args)
            return fn(*args, **kwargs)
        return rec

    for name in KERNELS:
        setattr(KERNELS[name][0], KERNELS[name][1], recorder(name))
    try:
        turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS)
    finally:
        for name, fn in originals.items():
            setattr(KERNELS[name][0], KERNELS[name][1], fn)
    return captured


def _stage_split(image, reps):
    """Median ms of each main-path stage, run in sequence as
    segment_turbo_impl runs them."""
    h, w = image.shape[:2]
    v = h * w
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
        lambda: turbo._final_map(gst, st2, rm, r0, 4 * (h + w)), reps)
    out["rounds_stage_g"] = gst.it
    return out


def _check_oracle(labels, image, oracle_path):
    got = canonical_min_labels_np(labels.cpu().numpy())
    oracle = np.load(ROOT / oracle_path)
    ndiff = int((got != oracle).sum())
    print(f"  oracle partition ({oracle_path}): {ndiff} pixels differ "
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
        print(f"  rerun with CPU-filter weights: flags {fl2}, {nd2} pixels "
              "differ from the oracle", flush=True)
        raise AssertionError("main path partition differs from the oracle")


def _run_path(path, image, card):
    """The counted main-path run of one path, its checks and its times.
    Returns (launch counts, main-path ms, stage split, peak MiB)."""
    h, w, _, sizes, oracle = PATHS[path]
    turbo._PEEL_SIZES = sizes
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    labels, flags = turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"main path {path}: flags {flags} ({turbo.describe_flags(flags)}),"
          f" launches {launches}, peak memory {peak:.1f} MiB", flush=True)
    if flags != 0:
        raise AssertionError(f"{path}: main path raised flags {flags}")
    idle = [n for n in KERNELS if path in KERNELS[n][5] and launches[n] == 0]
    if idle:
        raise AssertionError(f"{path}: main path never launched {idle}")
    stray = [n for n in KERNELS if path not in KERNELS[n][5] and launches[n]]
    if stray:
        raise AssertionError(f"{path}: main path launched {stray}, which "
                             "it must not run")
    _check_oracle(labels, image, oracle)
    reps = 9 if h * w < 4_000_000 else 5
    total_ms = _cuda_ms(
        lambda: turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS), reps)
    print(f"  main path {path}: median {total_ms:.3f} ms of {reps} reps = "
          f"{h * w / 1e6 / (total_ms / 1e3):.2f} MPix/s ({card})", flush=True)
    split = _stage_split(image, 3)
    print("  stage split (median ms of 3): " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in split.items()) + f" ({card})", flush=True)
    return launches, total_ms, split, peak


def _peel_ab(image, card, pairs=10):
    """Main-path ms of the subsum and the count peel on one image, one run
    each per pair, the order alternating between pairs (ABBA...)."""
    times = {"subsum": [], "count": []}
    for i in range(pairs):
        for sizes in (("subsum", "count") if i % 2 == 0
                      else ("count", "subsum")):
            turbo._PEEL_SIZES = sizes
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS)
            end.record()
            end.synchronize()
            times[sizes].append(start.elapsed_time(end))
    turbo._PEEL_SIZES = "subsum"
    wins = sum(a < b for a, b in zip(times["subsum"], times["count"]))
    out = {k: {"median": statistics.median(v),
               "quartiles": statistics.quantiles(v, n=4)[::2], "ms": v}
           for k, v in times.items()}
    print(f"peel A/B 1080p, {pairs} alternating pairs: subsum median "
          f"{out['subsum']['median']:.3f} ms (quartiles "
          f"{out['subsum']['quartiles']}), count median "
          f"{out['count']['median']:.3f} ms (quartiles "
          f"{out['count']['quartiles']}); subsum faster in {wins} of {pairs} "
          f"pairs ({card})", flush=True)
    return out


def _time_kernels(fields, label, card, plain_reps):
    """Check and time each captured kernel call: kernel ms (median of 5),
    plain ms, library ms where one exists, bound ms and passes per call."""
    out = {}
    for name, args in fields.items():
        err = _compare(name, args)
        before = _wrapper(name).launches
        _wrapper(name)(*args)
        passes = _wrapper(name).launches - before
        rec = {"max_abs_err": err, "passes": passes,
               "ms": _cuda_ms(lambda: _wrapper(name)(*args), 5),
               "plain_ms": _cuda_ms(lambda: KERNELS[name][2](*args),
                                    plain_reps)}
        lib = _library_call(name, args)
        rec["library_ms"] = _cuda_ms(lib, 5) if lib else None
        rec["bound_ms"], rec["bound_by"] = _bound(name, args)
        rec["device_ms"] = _device_ms(lambda: _wrapper(name)(*args), name)
        out[name] = rec
        device = ("not measured" if rec["device_ms"] is None
                  else f"{rec['device_ms']:.3f} ms")
        print(f"check {name} {label} main-path fields: equal to plain; "
              f"kernel {rec['ms']:.3f} ms ({passes} launches; on the device"
              f" {device}), plain "
              f"{rec['plain_ms']:.3f} ms, library "
              + (f"{rec['library_ms']:.3f} ms" if lib else "none")
              + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) "
              f"({card})", flush=True)
    return out


def _build_all():
    """One nvcc per source, all started together."""
    srcs = ("gossip", "extract", "pad")
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        futs = {s: pool.submit(_build.load, s, True) for s in srcs}
        for s, fut in futs.items():
            fut.result()
            print(f"build {s}.cu: {_build.build_seconds[s]:.2f} s",
                  flush=True)


def main() -> None:
    t0 = time.perf_counter()
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
    _build_all()

    errs = {name: 0.0 for name in KERNELS}
    for h, w in ((37, 150), (1081, 1919), (37, 2600), (160, 3840)):
        for name, args in _random_args(h, w, dev, seed=h * 7 + w).items():
            errs[name] = max(errs[name], _compare(name, args))
            print(f"check {name} {h}x{w}: equal to plain", flush=True)

    images, timed, runs = {}, {}, {}
    for path, (h, w, blobs, sizes, _) in PATHS.items():
        if (h, w) not in images:
            images[h, w] = torch.from_numpy(
                blobs_image(h, w, blobs, 8.0, 0)).to(dev)
        image = images[h, w]
        turbo._PEEL_SIZES = sizes
        # every kernel at the fields this path gives it; timed on the
        # default-configuration paths.
        fields = _capture_main_path_fields(image)
        missing = {n for n in KERNELS if path in KERNELS[n][5]} - set(fields)
        if missing:
            raise AssertionError(f"{path} never called {sorted(missing)}")
        if sizes == "count":
            for name, args in fields.items():
                errs[name] = max(errs[name], _compare(name, args))
                print(f"check {name} {path} main-path fields: equal to "
                      "plain", flush=True)
        else:
            timed[path] = _time_kernels(fields, path, card,
                                        plain_reps=3 if h < 2000 else 1)
            for name, rec in timed[path].items():
                errs[name] = max(errs[name], rec["max_abs_err"])
        runs[path] = _run_path(path, image, card)
    turbo._PEEL_SIZES = "subsum"
    ab = _peel_ab(images[1080, 1920], card)

    if "jax" in sys.modules or any(m.startswith("gseg_tpu.")
                                   for m in sys.modules):
        raise AssertionError("the port imported jax or gseg_tpu")
    kernels = []
    for name in KERNELS:
        # times at the default 1080p path's fields; the pads run only at 4K.
        rec = timed["4k_subsum" if name in PADS else "1080p_subsum"][name]
        rec4k = timed["4k_subsum"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][3],
            "replaces": KERNELS[name][4],
            "launches": sum(r[0][name] for r in runs.values()),
            "launches_by_path": {p: r[0][name] for p, r in runs.items()},
            "max_abs_err": errs[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "passes_per_call": rec["passes"], "device_ms": rec["device_ms"],
            "ms_4k": rec4k["ms"], "device_ms_4k": rec4k["device_ms"],
            "plain_ms_4k": rec4k["plain_ms"],
            "bound_ms_4k": rec4k["bound_ms"]})
    print("paths: " + json.dumps({
        p: {"main_ms": r[1], "stages_ms": r[2], "peak_mib": r[3]}
        for p, r in runs.items()} | {"peel_ab_1080p": ab}))
    print(f"chip_smoke wall time {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
