"""One run of one cell: set-up, a closed-loop window, the check, one line.

    python3 segbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (counted in setup_s, from the process's start to the first timed
frame): imports, CUDA's start, the pool of frames made from the seed and
pinned in host memory, the program's kernels loaded (built on a
checkout's first run, into the program's own cache inside the checkout)
and the cell's shapes warmed with WARM frames. Making the pool is data
made anew in every run, so it counts; its time is printed on a line of
its own beside the others.

The window: one caller hands frame after frame, cycling through the pool,
to `gseg_tpu_torch.segment(frame, config=cfg, device="cuda:0")`, on the
path the configuration's `algorithm` names (one of EXACT); a frame's
latency runs from the call until its labels are ready on the card
(`torch.cuda.synchronize`). The frames of the window's first pool cycle
and of two more cycles, starting at times drawn from the seed, are
copied to the host after their latency is taken. The window closes with
the first frame that ends past `--seconds`.

After the window: the peak of device memory is read, the program's state
freed, and the plain reference (`check.py`) decides `correct`. With
`--trace 1` the per-layer readers' instruments are on during the window,
which then lasts at most TRACE_SECONDS, under `torch.profiler`, and the
line carries the per-layer metrics, the
device's busy and window seconds and the breakdown; with `--trace 0` it
carries the end-to-end metrics.

The last line on standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines on standard
error and the result's last key.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import inspect
import json
import subprocess
import sys
import time
import traceback

import numpy as np

from . import check, frames, reference, spec
from .trace import FRAME, WINDOW, Trace

WARM = 3              # warm-up frames: the cell's shape, every kernel built
CHECK_CYCLES = 2      # pool cycles checked besides the window's first
# a traced run's window: at most this long (the profiler records some 9k
# events a 1080p frame, and reading back a million takes some 20 s)
TRACE_SECONDS = 10.0
FORBIDDEN = {"jax", "jaxlib", "flax", "gseg_tpu"}   # top-level names


def card(index: int) -> str:
    """The name and power limit of card `index` as nvidia-smi gives them
    (a card set below its maximum power runs slower under load)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        import torch
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def program_config(config: dict, overrides: dict | None = None):
    """The program's SegmentationConfig from a configuration file: every
    key that names one of its fields (the others describe the file)."""
    from gseg_tpu_torch.config import SegmentationConfig

    names = {f.name for f in dataclasses.fields(SegmentationConfig)}
    kw = {k: v for k, v in config.items() if k in names}
    return SegmentationConfig(**(kw | (overrides or {})))


# configuration keys with the one value that the harness and the
# reference implement, and keys that only describe the file
FIXED = {"entry": "gseg_tpu_torch.segment", "hierarchy_levels": 0,
         "quantize_weight_bits": 0, "on_overflow": "raise",
         "precision": "float32"}
# the values of `algorithm` the harness runs: exact device paths of
# `segment()`, each with why the frozen reference decides its answer
EXACT = {
    "turbo": "staged gossip and compact rounds, held to the sequential "
             "Boruvka oracle's partition (canonical min-pixel ids)",
    "atomic": "scatter-min Boruvka-Felzenszwalb rounds with canonical "
              "edge-id ties, the reference's own schedule (root ids)",
    "fastmst": "the same rounds in the DPP schedule, labels byte-equal to "
               "atomic's (root ids)",
}
# the other values of `algorithm`, and why the harness refuses each
REFUSED = {
    "superpixel": "a different criterion, which the reference does not "
                  "compute",
    "atomic_hostsync": "the same code as atomic in the port",
    "boruvka_cpu": "a host-only path, not the device path",
    "kruskal_cpu": "a host-only path, not the device path",
    "kruskal_native": "a host-only path, not the device path",
}
REQUIRED = reference.KEYS + ("algorithm", "on_overflow", "precision")
DESCRIBE = ("name", "source", "deployment", "guarantees", "assumed",
            "reduced")
# how a mix is offered: the loop this harness implements
OFFERED = {"loop": "closed", "callers": 1}


def check_cell(config: dict, traffic: dict) -> None:
    """Refuses a configuration or a mix that asks for anything the harness
    or the reference does not implement, or that the chosen path would
    refuse frame by frame, rather than measure something else.
    gossip_rounds, which `segment()` does not take, has to be the turbo
    entry's default, and names nothing on the other paths; they raise on
    weight_buckets > 0 (only turbo runs the bucket ramp)."""
    name = config.get("name")
    missing = [k for k in REQUIRED if k not in config]
    if missing:
        raise ValueError(f"configuration {name!r} lacks {missing}")
    for key, value in config.items():
        if key in FIXED and value != FIXED[key]:
            raise ValueError(f"configuration {name!r}: {key} {value!r}; the "
                             f"harness implements only {FIXED[key]!r}")
        if key not in FIXED and key not in REQUIRED \
                and key not in DESCRIBE and key != "gossip_rounds":
            raise ValueError(f"configuration {name!r}: the harness reads no "
                             f"key {key!r}")
    algorithm = config["algorithm"]
    if algorithm not in EXACT:
        why = REFUSED.get(algorithm, "not a path of segment()")
        raise ValueError(f"configuration {name!r}: algorithm {algorithm!r}, "
                         f"{why}; the harness implements {sorted(EXACT)}")
    if algorithm == "turbo":
        from gseg_tpu_torch.models import turbo

        default = inspect.signature(turbo.segment_turbo).parameters[
            "gossip_rounds"].default
        if config.get("gossip_rounds", default) != default:
            raise ValueError(f"configuration {name!r} asks for gossip_rounds"
                             f" {config['gossip_rounds']}; segment() runs "
                             f"{default}")
    elif "gossip_rounds" in config:
        raise ValueError(f"configuration {name!r}: gossip_rounds; the "
                         f"{algorithm} path does not read it")
    elif config["weight_buckets"] > 0:
        raise ValueError(f"configuration {name!r}: weight_buckets "
                         f"{config['weight_buckets']}; the {algorithm} path "
                         "has no bucket ramp and segment() refuses it")
    for key, value in OFFERED.items():
        if traffic.get(key) != value:
            raise ValueError(f"traffic {traffic.get('name')!r}: {key} "
                             f"{traffic.get(key)!r}; the harness implements "
                             f"only {value!r}")
    frames.check_traffic(traffic)


@dataclasses.dataclass
class Window:
    pixels: int = 0        # pixels of the frames completed
    seconds: float = 0.0   # from the first call to the last frame's end
    latencies: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    checked: list = dataclasses.field(default_factory=list)
    peak: int = 0
    setup_s: float = 0.0


def _p95_ms(w: Window) -> float:
    return float(np.percentile(w.latencies, 95)) * 1e3


# end-to-end metric -> its reading of the window
END_TO_END = {
    "mpix_per_s": lambda w: w.pixels / w.seconds / 1e6,
    "latency_p95_ms": _p95_ms,
    "peak_mem_mib": lambda w: w.peak / 2**20,
    "setup_s": lambda w: w.setup_s,
}


def check_starts(seed: int, seconds: float) -> list[float]:
    """Times into the window (s) after which a checked pool cycle
    starts, drawn from the seed."""
    rng = np.random.default_rng(frames.seed_sequence(seed, 1))
    return sorted(float(x) for x in rng.uniform(0.0, 0.9 * seconds,
                                                 CHECK_CYCLES))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(segment, host_frames, dev, seconds: float, starts, tr,
            err) -> Window:
    """The closed loop over the pool until a frame ends past `seconds`."""
    w = Window()
    pool = len(host_frames)
    pending = list(starts)
    check_upto = pool  # the window's first cycle is always checked
    labels = None
    span = tr.record if tr else (lambda n: contextlib.nullcontext())
    with span(WINDOW):
        t_start = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            if t - t_start >= seconds and i > 0:
                break
            if i % pool == 0 and pending and t - t_start >= pending[0]:
                pending.pop(0)
                check_upto = i + pool
            img = host_frames[i % pool]
            with span(FRAME):
                try:
                    labels = segment(img)
                    _sync(dev)
                except Exception:  # the frame failed; the run goes on
                    if w.failed == 0:
                        traceback.print_exc(file=err)
                    w.failed += 1
                    labels = None
            t_end = time.perf_counter()
            w.latencies.append(t_end - t)
            w.attempted += 1
            if labels is not None:
                w.pixels += img.shape[0] * img.shape[1]
            if i < check_upto:
                w.checked.append((i % pool, None if labels is None
                                  else labels.cpu().numpy()))
            w.seconds = t_end - t_start
            i += 1
    if tr:
        tr.frames = w.attempted
    return w


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root=spec.ROOT, device=None, t0: float | None = None,
        program_overrides: dict | None = None, out=None, err=None) -> int:
    """One run; returns the exit code. device=None looks for the cell's
    chips (none: exit 2, no result); the tests give "cpu" and skip the
    look. program_overrides: settings changed for the program alone, not
    for the reference (the controls of `control.py`)."""
    t0 = time.perf_counter() if t0 is None else t0
    out = out or sys.stdout
    err = err or sys.stderr
    c = spec.cell(workload, root)
    unknown = [m["name"] for m in c["end_to_end"]
               if m["name"] not in END_TO_END]
    if unknown:
        raise KeyError(f"end-to-end metrics {unknown} have no reading")

    import torch

    chips = c["entry"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"segbench: {workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=err)
            return 2
        device = "cuda:0"
        print(f"segbench: card {card(0)}", file=err)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)  # CUDA's start, timed on its own
    t_cuda = time.perf_counter()

    import gseg_tpu_torch

    check_cell(c["config"], c["traffic"])
    cfg = program_config(c["config"], program_overrides)
    t_import = time.perf_counter()
    pool = frames.make_pool(c["traffic"], seed)
    t_pool = time.perf_counter()
    host_frames = [torch.from_numpy(f) for f in pool]
    if dev.type == "cuda":
        host_frames = [f.pin_memory() for f in host_frames]
    t_frames = time.perf_counter()
    print(f"segbench: {len(pool)} frames of {pool[0].shape} made from the "
          f"seed in {t_pool - t_import:.3f} s, pinned in "
          f"{t_frames - t_pool:.3f} s", file=err)

    def segment(img):
        return gseg_tpu_torch.segment(img, config=cfg, device=dev)

    warm = []
    for i in range(WARM):
        t = time.perf_counter()
        segment(host_frames[i % len(pool)])
        _sync(dev)
        warm.append(round(time.perf_counter() - t, 4))
    setup_s = time.perf_counter() - t0
    print(f"segbench: {workload} seed {seed}: set-up {setup_s:.3f} s: "
          f"to CUDA's start {t_cuda - t0:.3f}, the program's import "
          f"{t_import - t_cuda:.3f}, the frames {t_frames - t_import:.3f}, "
          f"warm-up frames {warm}", file=err)

    tr, readers = None, {}
    if trace:
        tr = Trace(dev)
        for m in c["per_layer"]:
            reader = spec.layer_reader(m["name"], root)
            if reader.instrument(tr):
                readers[m["name"]] = reader
            else:
                print(f"segbench: {m['name']}: nothing to wrap, the metric "
                      "is missing", file=err)
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if tr:
        seconds = min(seconds, TRACE_SECONDS)
        tr.start()
    try:
        w = measure(segment, host_frames, dev, seconds,
                    check_starts(seed, seconds), tr, err)
    finally:
        if tr:
            tr.restore()
    if tr:
        t_stop = time.perf_counter()
        tr.stop()
        print(f"segbench: trace of {tr.events_read} events read in "
              f"{time.perf_counter() - t_stop:.3f} s", file=err)
    n = len(pool)
    per_frame = [float(np.median(w.latencies[i::n])) * 1e3
                 for i in range(min(n, len(w.latencies)))]
    print(f"segbench: median ms of each pool frame {per_frame}", file=err)
    w.setup_s = setup_s
    w.peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
              else 0)
    del host_frames
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    needed = {i: pool[i] for i, _ in w.checked}
    refs = check.reference_partitions(needed, c["config"])
    checks = check.compare(w.checked, refs, w.failed)
    print(f"segbench: {w.attempted} frames in {w.seconds:.3f} s, "
          f"{len(w.checked)} checked against the reference in "
          f"{time.perf_counter() - t_ref:.3f} s", file=err)

    if trace:
        metrics = {}
        for m in c["per_layer"]:
            v = readers[m["name"]].read(tr) if m["name"] in readers else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": END_TO_END[m["name"]](w),
                               "unit": m["unit"]} for m in c["end_to_end"]}

    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"segbench: the process loaded {found}; the benchmark runs "
              "the port alone", file=err)
        return 3

    result = {
        "correct": check.passed(checks),
        "attempted": w.attempted,
        "failed": w.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type),
            "count": chips,
            "memory_peak_bytes": w.peak,
        },
    }
    if tr:
        result["device"]["busy_s"] = tr.busy_s or 0.0
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    for line in check.lines(checks):
        print(line, file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(prog="segbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return run(a.workload, a.seed, a.seconds, bool(a.trace), t0=t0)
