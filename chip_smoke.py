"""Drive the PyTorch port's main paths once on a CUDA card and check them.

Run from the repository root: `python3 chip_smoke.py` (one card, no
arguments). It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from `gseg_tpu_torch/csrc/` (one nvcc per
     source, all started together; sm_90a): the TPU kernels' counterparts,
     the superpixel path's colour-sum helper, stage 2's compact round and
     the join of the chunked pair dedup's chunk fronts;
  3. holds every kernel against its plain PyTorch version on the same CUDA
     tensors: random fields at odd multi-tile shapes and at wide shapes
     (w >= 2560: the padded fixpoint route), both closure orientations,
     the closure-route fixpoints (`closures=True`, with `WARM_PASSES` 0)
     and run extraction at the identity labeling (which overflows); a
     1081x1919 serpentine component whose geodesic diameter (1,000-8,000
     px) outruns the 64 warm step passes, so the closure route runs at the
     default `WARM_PASSES`; pad and unpad at ragged widths (37x2563,
     1081x2599: the register route) and at 4K and 8K planes (the bulk
     route), with 1-4 fields, t 0 and 8 and every inert fill, the route
     read from the profiler; then the fields captured from the main paths
     (pad/unpad also on copies offset by one word, which take the register
     route). Fixpoints, closures and pads must be bit-equal, the
     extraction pools equal as sorted multisets. Each step-kernel variant
     is also driven pass by pass with tile skipping on (`kg._pass_loop`),
     every pass by the kernel (`kg.step_pass`) and by
     `kg.step_pass_plain` from the same input into copies of the same
     destination: fields, act bytes and the changed flag must agree after
     every pass, at the random shapes and at each path's fields (the
     label flood with its seed);
  4. runs `segment_turbo_flagged` (sigma 0.8, k 300, min_size 100,
     max_iters 32, gossip_rounds 2) on seven main paths, then three more
     paths at 1080p (step 6), each with the launch counts set to 0 just
     before it and read just after:
       - 1080p, the default configuration (subsum peel rounds):
         blobs_image(1080, 1920, 31, 8.0, 0);
       - 1080p, the count peel (`turbo._PEEL_SIZES = "count"`);
       - 4K, the default configuration: blobs_image(2160, 3840, 126, 8.0, 0);
       - 1080p quality mode (weight_buckets 16), default `WARM_PASSES`;
       - 1080p quality mode with `kg.WARM_PASSES = 0`: every hybrid
         fixpoint on the closure route from its first pass;
       - 1080p, the runs peel (`turbo._PEEL_SIZES = "runs"`);
       - 4K quality mode (weight_buckets 16), default `WARM_PASSES`: the
         padded route with the closure route past the warm passes;
     and requires flags == 0, the launch counts of PERF.md §5
     (`RECORDED_LAUNCHES`), the canonical partition of the committed
     oracle (bench_out/oracle_bench_{1080x1920,2160x3840}_wb0.npy,
     bench_out/oracle_bench_1080x1920_wb16.npy, and the port's
     gseg_tpu_torch/oracles/blobs_2160x3840_wb16.npz), a launch of every
     kernel that path must run (pad and unpad only at 4K, the closures in
     both orientations on the closure path, run extraction on the runs
     path), and none of a kernel the path must not run;
  5. times each path (median of CUDA-event reps after a warm-up), its
     stages, its peak memory, and each kernel beside its plain version,
     its bytes bound and, where one exists, a PyTorch call computing the
     same function (call time in turns with the kernel's, and device
     time); pad/unpad on both routes, with the L2 cache flushed, and at
     8K planes too; the closures' rows and columns launches (CUDA events)
     at the 1080p and the padded 4K fields; for the step kernel at the
     fixpoint fields also the device time with `kg.TILE_SKIP` off, the
     share of tiles the gated call computed, its in-tile steps per tile,
     and each pass's tiles and device time (gated and ungated) with a fit
     ms = a + b x tiles; per
     path, the step kernel's device time (profiler) over one whole
     main-path run with `kg.TILE_SKIP` on and off in turns (on, off, off,
     on), which must give the same labels and launches, with the
     active-tile share of the gated runs (device counters: tiles computed
     / tiles launched, each fixpoint's first pass counted as full) and the
     bytes bound of the tiles computed; then the 1080p subsum and count
     peels in 4 alternating pairs. Run extraction is also held on 9-row
     planes 1 to 3840 wide (one run a row, or runs of one pixel) at caps
     0, 1, count - 1 and count, and timed (its row and fill launches, the
     fill's bytes past the count beside the bound, `torch.bincount`) on
     each peel round's label plane of the 1080p runs path and the 4K
     default path;
  6. drives the atomic path (`segment_atomic`, which launches none of the
     kernels; its rounds and host reads), its hierarchy and the turbo
     hierarchy (`segment_turbo_hierarchy_flagged`: flags 0, the recorded
     launches, level 0 the identity, every level nested in the next, final
     labels equal to `segment_turbo_flagged`'s) on the 1080p default
     image: final labels 0 pixels off the 1080p oracle, every level's
     canonical sha256 equal to the committed level oracle
     (gseg_tpu_torch/oracles/levels_blobs_1080x1920_wb0.json) and the two
     hierarchies equal level by level; each timed by CUDA-event reps;
  7. drives the DPP paths (`models.fastmst`, `models.superpixel`) on the
     same 1080p image, and fastmst on the 4K one: `1080p_fastmst` and
     `4k_fastmst` (`segment_fastmst_flagged`: flags 0, 0 pixels off the
     1080p / 4K oracle, at 1080p root ids byte-equal to `segment_atomic`'s
     and to the level oracle's raw sha256), `1080p_fastmst_hierarchy`
     (level 0 the identity, levels nested, final labels those of
     `1080p_fastmst`, every one of its 34 planes equal to the level oracle
     gseg_tpu_torch/oracles/levels_dpp_blobs_1080x1920.json),
     `1080p_superpixel` (level 4 equal to the oracle's plane 4) and
     `1080p_superpixel_hierarchy` (33 planes equal to the oracle, down to
     one component, two runs bit-equal); each with the launch counts set
     to 0 just before it and read just after (RECORDED_LAUNCHES: the value
     flood, pad/unpad at 4K, the colour-sum helper on superpixel, stage
     2's round on fastmst, the pair dedup's join on both, one a frame;
     every round of the 4K frame, V-indexed with sink labels, also against
     the round's plain version and its first one timed; the join at the
     4K frame's boundary pairs, and forced to overflow at half its heads,
     at the fastmst and superpixel hierarchies' and each row-sharded
     rank's of `1080p_spatial4` (step 10) against its plain version in
     every lane and the overflow flag, and timed at 4K), its
     host reads, peak memory, median ms of CUDA-event reps, the value
     flood's device ms and the split of round 1, extraction, compact
     rounds and final map or render; the colour-sum helper
     (`kernels.scatter.ordered_scatter_add`, `csrc/scatter.cu`) is held
     against its plain version at the random shapes and timed at the
     superpixel path's round-1 call;
  8. drives the CLI (`gseg_tpu_torch.cli.main`, in this process, on the
     default device) on the 1080p image written as a PPM: `1080p_cli`
     (`--algorithm turbo`: labels 0 pixels off the 1080p oracle,
     launches those of `1080p_subsum`, out.ppm one colour per component
     and as many colours as components), the same command as `python -m
     gseg_tpu_torch` in a subprocess (labels equal), `1080p_cli_level4`
     (`--hierarchy-level 4`: the level oracle's level 4, the turbo
     hierarchy's launches) and `1080p_cli_kruskal_native` (the C++
     baseline on the host, built with g++: no launch, every component at
     least min_size; its time beside the host CPU's name and the
     reference's CPU baseline on its own machine);
  9. runs the reference's quality protocol (scripts/run_evidence.py:
     241-300) over `bsds_like_quality_set(n=20)` (321x481, 5
     pseudo-ground-truths each) at K=80, min_size 100, on_overflow
     "fallback": turbo, fastmst and superpixel at hierarchy level 4
     (`bench.harness.segment_level_fn`), turbo_wb16's final map, atomic,
     kruskal_native and boruvka_cpu (`segment_fn`), each algorithm with
     the launch counts set to 0 just before its 20 images and read just
     after (RECORDED_LAUNCHES), its host reads, median ms per image and
     hybrid fixpoints; after holding every kernel of the turbo paths
     against its plain version at image 0's fields, and the value flood
     (and superpixel's colour-sum helper) at every call that the fastmst
     and superpixel rows make on image 0. Every row is scored
     with `asa_ue_best_gt` on the host and with `asa_ue_torch` on the
     card (equal), and must equal the committed record
     (bench_out/bsds_quality.jsonl) exactly;
 10. drives batching and multi-device (`gseg_tpu_torch.parallel`) on
     cuda:0, the ranks of a mesh as threads taking turns on the one card:
     `segment_batch` of four 1080p and two 4K images (image 0 0 pixels off
     its oracle, every image equal to a single call; at 1080p also
     `segment_batch_sharded` over two ranks), `segment_turbo_spatial` over
     4 ranks at 1080p (speed and quality mode) and 4K and over 8 ranks of
     6-row tiles (labels equal to dense, 0 pixels off the oracles), and
     the row-sharded atomic path (`segment_spatial`, `multichip_step` on a
     2 x 2 mesh; root ids equal to `segment_atomic`'s). Each with its
     launches, host reads, peak memory and median ms; no plain sweep may
     run. On every spatial turbo path, the slab passes of a top, a middle
     and a bottom rank, for each step variant, are held against
     `step_pass_plain` (max_abs_err 0);
 11. runs the bench's performance half (`gseg_tpu_torch.bench`): the
     resolution ladder, `python -m gseg_tpu_torch.bench perf --algorithms
     turbo,atomic,fastmst --reps 5` in this process (rungs 540p to 4K at
     the default --max-mpix 9.0, the main path's configuration; its
     perf.jsonl in the gitignored bench_out/torch/), counted as one path:
     every row flags 0, every kernel of the turbo, fastmst and padded
     paths launched; each row's times, inner calls and filter_graph
     stage. Then one more counted run of every row through the callable
     the ladder timed: 0 pixels off its rung's oracle
     (gseg_tpu_torch/oracles/blobs_{540x960,720x1280,1440x2560}_wb0.npz,
     bench_out/oracle_bench_{1080x1920,2160x3840}_wb0.npy), the recorded
     launches (the 1080p and 4K turbo rows those of 1080p_subsum and
     4k_subsum), host reads and peak memory, and beside the 1080p and 4K
     turbo rows the same callable's CUDA-event median of 25 calls (with
     the host clock around the same calls). The 1440p rung's fields (2560
     wide, the padded route) are held and timed as the main paths' are
     (gated passes, pad and unpad on both routes). Then
     `bench.profile_turbo` at 1080p and 4K and at 1080p wb16, 10 reps
     (each prefix's wall ms beside the device ms of one more call under
     `utils.timing.profile_trace`), five `PhaseTimer` runs at 1080p (prep,
     segment; their median total within 1.5x of the ladder's median),
     `bench.fig3` at 480x854 with 100 reps and `bench.flagship`'s JSON
     line;
 12. holds the step kernel at T 4, 16 and 32 steps per pass (8 is step
     3's) pass by pass against `kg.step_pass_plain` at the same T: every
     variant at RANDOM_SHAPES (the wide ones included) and at the 4K
     main path's fields, fields, act bytes and the changed flag bit-equal
     after every pass; runs each variant's fixpoint at each T on the
     1080p and 4K main paths' fields through the wrappers' own route
     (`kg._run_fixpoint`: 1080p at `kg.STEPS` = T, 4K padded at
     `kg.STEPS_WIDE` = T), equal to the plain fixpoint, each launch timed
     by CUDA events behind a device sleep (no profiler: late in a long
     process its windows came back empty): device ms a call and a
     launch, launches, the bound of one ungated launch's (TILE + 2T)^2
     slab loads; then drives
     the turbo path's exact alternatives (ALTERNATIVES: module attributes
     of `models.turbo` and `ops.kernels.gossip`), each with the launch
     counts set to 0 just before it and read just after: the final-map
     gather at 1080p, 4K, on the turbo hierarchy (every level equal to
     the level oracle) and on 4 row-sharded ranks (labels equal to
     dense), the pointer-resolved flood at 1080p and 4K, quality mode's
     root list unsplit, speed mode's late rounds on the closure route,
     quality mode without closures, T = 16 at 4K (pads at t = 16) and
     the closure route from the first pass at T_SCAN = 4 (the T of each
     step launch recorded): flags 0, 0 pixels off the
     path's oracle, its RECORDED_LAUNCHES, every kernel it must run and
     none it must not; its host reads and peak memory beside its
     default's, and two A B B A pairs of CUDA-event medians (3 calls
     each) of the default and the alternative.

 13. runs the reference's hardware parity protocol and the rows of its
     record the card had not run, each row with the launch counts set to
     0 just before it and read just after (RECORDED_LAUNCHES), its host
     reads, peak memory and `bench.harness._timed` median (3 reps of one
     call) with MPix/s: `python -m gseg_tpu_torch.bench.parity` in this
     process (the 20-seed synthetic sweep at k 30, min_size 10; 540p
     blobs and textured at the bench configuration, against
     `segment_boruvka_np` on the host; textured 1080p k 10, min_size 10,
     wb16 against its committed oracle), then each of its rows counted;
     `python -m gseg_tpu_torch.bench.spatial_parity` (the row-sharded
     turbo path against the dense one: 540p on 4 ranks, 720p on 8, blobs
     and textured, wb0 and wb16, the ranks on cuda:0), then each row's
     dense and row-sharded runs counted (labels equal); the ladder's 5K
     and 8K rungs for turbo, atomic and fastmst
     (`run_performance_ladder(resolutions=[(2880, 5120), (4320, 7680)])`)
     and the textured turbo rows at 540p, 1080p and 4K (`content=
     "textured"`), each counted as one path and every row re-run, counted,
     against its committed oracle. Every row: flags 0, 0 pixels off (or
     equal), its recorded launches; no plain sweep may run.
 14. runs the reference's evidence tooling on the rows of its records the
     card had not run, writing its records to `bench_out/torch/step14/`:
     `python -m gseg_tpu_torch.bench.sweep` in this process at 1080p over
     the speed configs and (quality mode) baseline and the quality
     configs, and at 4K over baseline and nofastpad, each sweep counted
     as one path and each row's warm-up launches held against
     RECORDED_LAUNCHES: flags 0 and the oracle's partition, or (gate13,
     gateq8, gateq8nc) FLAG_PAIR_OVERFLOW from the candidate pool alone,
     shown by a probe of the handoff (candidates over the reference's
     cap_live, pairs within the pair pool); 4K nofastpad bit-equal to the
     padded route with no pad or unpad launch; `bench.evidence`'s quality
     section (the synthetic set, 20 images, 7 algorithms, each counted
     as one path), every ASA and UE equal to `bench_out/quality.jsonl`;
     its perf section over superpixel at 540p, 720p and 1080p and
     atomic_hostsync and turbo_wb16 at 540p, counted as one path, each
     row flags 0 and its oracle's partition and re-run counted; then
     `bench.summarize` over the step's records, printed.
 15. holds stage 2's two label spaces on the benchmark's four frames
     (blobs 1080p in speed and quality mode, blobs 4K, the 321x481
     photo-like scene): `_s2_stage` V-indexed (no root list) and in
     root-index space, fin, the flags, the last phase's rounds and the
     final labels bit-equal, every round one launch of the hand-written
     round (as RECORDED_LAUNCHES has them); it prints stage 2's
     milliseconds in each space and each stage's peak allocation. Then
     the 540p row-sharded turbo path on 4 ranks (whose rounds run in
     root space) against its V-indexed rounds and dense, timed both ways,
     and taking turns against running free; the turbo hierarchy and
     fastmst at 1080p, and fastmst at 4K (their rounds V-indexed), each
     with its launches as recorded and a second run equal to the first.

`python3 chip_smoke.py --cards`, on a machine with several cards, runs
only the row-sharded paths with one rank on each card (PERF.md: each
rank's peak memory). `python3 chip_smoke.py --alternatives` builds the
kernels and runs step 12 alone, `python3 chip_smoke.py --parity` step 13,
`python3 chip_smoke.py --evidence` step 14, `python3 chip_smoke.py
--s2-spaces` step 15.

Every failure propagates and the script exits non-zero; no kernel falls
back to its plain version and nothing moves to the CPU. The last two lines
are a JSON record of the kernels and `{"ok": true, "device": {...}}`.
There is no CPU path.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path as FsPath
from typing import NamedTuple

import numpy as np
import torch

from gseg_tpu_torch.bench import __main__ as bench_main
from gseg_tpu_torch.bench import (evidence, fig3, flagship, harness, parity,
                                  profile_turbo, spatial_parity, summarize,
                                  sweep)
from gseg_tpu_torch.config import SegmentationConfig
from gseg_tpu_torch.metrics.compare import asa_ue_best_gt, asa_ue_torch
from gseg_tpu_torch.models import atomic_boruvka, fastmst, superpixel, turbo
from gseg_tpu_torch.ops import filters
from gseg_tpu_torch.ops import grid_graph as gg
from gseg_tpu_torch.ops.kernels import _build
from gseg_tpu_torch.ops.kernels import extract as kx
from gseg_tpu_torch.ops.kernels import gossip as kg
from gseg_tpu_torch.ops.kernels import pad as kp
from gseg_tpu_torch.ops.kernels import pairjoin as kpj
from gseg_tpu_torch.ops.kernels import runs as kr
from gseg_tpu_torch.ops.kernels import s2round as ks2
from gseg_tpu_torch.ops.kernels import scatter as ks
from gseg_tpu_torch.parallel import batching, spatial, turbo_spatial
from gseg_tpu_torch.parallel.mesh import Mesh, run_ranks
from gseg_tpu_torch.oracles import (load_level_oracle, load_oracle,
                                    oracle_path)
from gseg_tpu_torch.utils import timing
from gseg_tpu_torch.utils.labels import (canonical_min_labels_np,
                                         compact_labels_np)
from gseg_tpu_torch.utils.synthetic import blobs_image

ROOT = FsPath(__file__).resolve().parent
CFG = SegmentationConfig(sigma=0.8, k=300.0, min_size=100, max_iters=32,
                         algorithm="turbo")
GOSSIP_ROUNDS = 2


class Path(NamedTuple):
    h: int
    w: int
    blobs: int
    sizes: str                # peel sizes (speed mode)
    oracle: FsPath
    weight_buckets: int = 0
    warm_passes: int | None = None  # kg.WARM_PASSES for the path (None: 64)


_WB0 = ROOT / "bench_out/oracle_bench_1080x1920_wb0.npy"
_WB16 = ROOT / "bench_out/oracle_bench_1080x1920_wb16.npy"
PATHS = {
    "1080p_subsum": Path(1080, 1920, 31, "subsum", _WB0),
    "1080p_count": Path(1080, 1920, 31, "count", _WB0),
    "4k_subsum": Path(2160, 3840, 126, "subsum",
                      ROOT / "bench_out/oracle_bench_2160x3840_wb0.npy"),
    "1080p_wb16": Path(1080, 1920, 31, "subsum", _WB16, 16),
    "1080p_wb16_closures": Path(1080, 1920, 31, "subsum", _WB16, 16, 0),
    "1080p_runs": Path(1080, 1920, 31, "runs", _WB0),
    "4k_wb16": Path(2160, 3840, 126, "subsum",
                    FsPath(oracle_path("blobs_2160x3840_wb16")).resolve(), 16),
}
QUALITY = {"1080p_wb16", "1080p_wb16_closures", "4k_wb16"}
# random-field shapes: odd multi-tile, 1080p-sized, and wide (w >= 2560).
RANDOM_SHAPES = ((37, 150), (1081, 1919), (37, 2600), (160, 3840))
SERPENTINE = (1081, 1919)
# pad/unpad check shapes -> the route alignment gives their planes: ragged
# widths (w % 4 != 0), the 4K main path's and an 8K frame's.
PAD_SHAPES = {(37, 2563): "regs", (1081, 2599): "regs",
              (2160, 3840): "bulk", (4320, 7680): "bulk"}
PAD_8K = (4320, 7680)
# t -> fills of four planes (int32, float32, int32, int32): at t = 8 the
# compmin fixpoint's, at t = 0 the other inert fills of kg._VARIANTS, and
# at t = 16 and 32 (the step kernel's wide steps per pass) both mixed.
PAD_FILLS = {8: (-1, float("inf"), kg.INT32_MAX, 0),
             0: (8, 0.0, kg.BIGDIST, 0),
             16: (kg.INT32_MAX, 0.0, kg.BIGDIST, -1),
             32: (0, float("inf"), 8, kg.INT32_MAX)}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
_GOSSIP = "gseg_tpu/ops/pallas/gossip.py:386 (_strip_call_skip, "
_CLOSURE = "gseg_tpu/ops/pallas/gossip.py:265 (_strip_call, call :359, via "\
    "_hybrid_fixpoint :927: "


class Kernel(NamedTuple):
    mod: object               # module holding the wrapper
    attr: str                 # wrapper name
    plain: object             # plain PyTorch version
    source: str               # CUDA source
    replaces: str             # TPU kernel it replaces
    must: set                 # paths that must launch it
    may: set                  # paths that may launch it
    bytes_px: int | None      # bytes per pixel of one read of every input
    #                           and one write of every output, per launch
    ops_px: int               # operations per pixel per launch
    symbols: tuple            # regexes of its device kernels' names


# beside segment_turbo_flagged's paths, _new_paths runs 1080p_atomic and
# 1080p_atomic_hierarchy (no kernel) and the turbo hierarchy.
TURBO_HIERARCHY = "1080p_turbo_hierarchy"
LEVEL_ORACLE = "levels_blobs_1080x1920_wb0"
# step 8: the CLI (`gseg_tpu_torch.cli`) at 1080p: the turbo path,
# its hierarchy's level 4, and the C++ kruskal_native baseline on the host
CLI = "1080p_cli"
CLI_LEVEL4 = "1080p_cli_level4"
CLI_NATIVE = "1080p_cli_kruskal_native"
# the reference's CPU baseline (official Felzenszwalb C++) at 1080p, total,
# on the reference's machine (BASELINE.md:49)
REFERENCE_CPU_1080P_S = 2.60
# step 9: the reference's quality protocol (scripts/run_evidence.py:69-77,
# :241-300): K=80, min_size 100, on_overflow "fallback", hierarchy level
# 4 (turbo_wb16: the final map) over bsds_like_quality_set(n=20)
QUALITY_ALGOS = (("turbo", {}), ("turbo_wb16", {"weight_buckets": 16}),
                 ("fastmst", {}), ("atomic", {}), ("superpixel", {}),
                 ("kruskal_native", {}), ("boruvka_cpu", {}))
BSDS = {name: f"bsds_like_quality_{name}" for name, _ in QUALITY_ALGOS}
QUALITY_RECORD = ROOT / "bench_out/bsds_quality.jsonl"
ALL = set(PATHS) | {TURBO_HIERARCHY, CLI, CLI_LEVEL4, BSDS["turbo"],
                    BSDS["turbo_wb16"]}
SPEED_SUBSUM = {"1080p_subsum", "4k_subsum", CLI}
# step 7: the DPP paths (gseg_tpu_torch.models.fastmst / superpixel), each
# with the launch counts set to 0 just before it and read just after.
DPP_ORACLE = "levels_dpp_blobs_1080x1920"
FASTMST = ("1080p_fastmst", "4k_fastmst", "1080p_fastmst_hierarchy")
SUPERPIXEL = ("1080p_superpixel", "1080p_superpixel_hierarchy")
DPP = set(FASTMST + SUPERPIXEL)
# the reference CUDA code's total ms on a GTX 1080 Ti (BASELINE.md:53, :55)
GTX1080TI_MS = {
    "1080p_fastmst": ("DPP Segment. Hier. at 1080p", 71.1),
    "1080p_fastmst_hierarchy": ("DPP Segment. Hier. at 1080p", 71.1),
    "4k_fastmst": ("DPP Segment. Hier. at 4K", 242.2),
    "1080p_superpixel": ("DPP Superpix. Hier. at 1080p", 75.2),
    "1080p_superpixel_hierarchy": ("DPP Superpix. Hier. at 1080p", 75.2),
}
# step 10: batching and multi-device (gseg_tpu_torch.parallel) on cuda:0,
# the ranks of a mesh as threads on the one card
BATCH = ("1080p_batch4", "4k_batch2")
SPATIAL_TURBO = ("1080p_spatial4", "1080p_spatial4_wb16", "4k_spatial4",
                 "spatial8_short_tiles")
SPATIAL_ATOMIC = ("1080p_spatial_atomic4", "1080p_multichip_2x2")
TURBO_NEW = set(BATCH + SPATIAL_TURBO)
# step 11: the bench's performance half. `python -m gseg_tpu_torch.bench
# perf` in process at its default --max-mpix 9.0 (the rungs 540p-4K), its
# whole run counted as LADDER_RUN; then each row re-run once, counted, as
# ladder_<algorithm>_<h>x<w>, against its rung's oracle.
LADDER_RUN = "ladder_perf"
LADDER_ALGOS = ("turbo", "atomic", "fastmst")
LADDER_ORACLES = {
    (540, 960): FsPath(oracle_path("blobs_540x960_wb0")).resolve(),
    (720, 1280): FsPath(oracle_path("blobs_720x1280_wb0")).resolve(),
    (1080, 1920): _WB0,
    (1440, 2560): FsPath(oracle_path("blobs_1440x2560_wb0")).resolve(),
    (2160, 3840): ROOT / "bench_out/oracle_bench_2160x3840_wb0.npy",
}
LADDER = {f"ladder_{a}_{h}x{w}": (a, h, w) for h, w in LADDER_ORACLES
          for a in LADDER_ALGOS}
LADDER_TURBO = {p for p, (a, _, _) in LADDER.items() if a == "turbo"}
LADDER_DPP = {p for p, (a, _, _) in LADDER.items() if a == "fastmst"}
# the padded route: w >= 2560 (gseg_tpu/ops/pallas/gossip.py:703)
LADDER_WIDE = {p for p, (a, _, w) in LADDER.items()
               if a != "atomic" and w >= 2560}
LADDER_T = LADDER_TURBO | {LADDER_RUN}
# step 12: the turbo path's exact alternatives (module attributes of
# models.turbo and ops.kernels.gossip; ALTERNATIVES below), each against
# the default it replaces
ALT_GATHER = ("1080p_final_gather", "4k_final_gather",
              "1080p_turbo_hierarchy_final_gather",
              "1080p_spatial4_final_gather")
ALT_PTR = ("1080p_flood_ptr", "4k_flood_ptr")
ALT_WB16 = ("1080p_wb16_rlist_nosplit", "1080p_wb16_no_q_closures",
            "1080p_wb16_closures_tscan4")
ALT_SPEED = ("1080p_late_closures", "4k_t16")
ALT = set(ALT_GATHER + ALT_PTR + ALT_WB16 + ALT_SPEED)
ALT_4K = {"4k_final_gather", "4k_flood_ptr", "4k_t16"}
# speed mode with the subsum peel (no hierarchy: its peel counts); on the
# row-sharded path every round sizes by subtree sums
ALT_SUBSUM = ALT - set(ALT_WB16) - {"1080p_turbo_hierarchy_final_gather"}
# the closure kernels: the paths on the closure route from the first pass,
# and those whose hybrid fixpoints may pass the warm passes
CLOSURE_MUST = {"1080p_wb16_closures", "1080p_wb16_closures_tscan4"}
CLOSURE_MAY = {"1080p_wb16", "4k_wb16", "1080p_wb16_rlist_nosplit",
               "1080p_late_closures"}
KERNELS = {
    "gossip_compmin": Kernel(
        kg, "compmin_gossip", kg.compmin_gossip_plain,
        "gseg_tpu_torch/csrc/gossip.cu", _GOSSIP + "_compmin_step :997)",
        ALL | TURBO_NEW | LADDER_T | ALT, set(), 28, 40,
        (r"\bfixpoint_pass<.*\bCompminOp\b",)),
    "gossip_labeldist": Kernel(
        kg, "label_gossip", kg.label_gossip_plain,
        "gseg_tpu_torch/csrc/gossip.cu",
        _GOSSIP + "_label_step :1057, via label_gossip :1228)",
        SPEED_SUBSUM | TURBO_NEW | LADDER_T | ALT_SUBSUM, set(), 28, 48,
        (r"\bfixpoint_pass<.*\bLabelDistOp\b",)),
    "gossip_labelnd": Kernel(
        kg, "label_flood", kg.label_flood_plain,
        "gseg_tpu_torch/csrc/gossip.cu", _GOSSIP + "_labelnd_step :1086)",
        ALL | set(BATCH) | LADDER_T
        | ALT - set(ALT_PTR) - {"1080p_spatial4_final_gather"}, set(), 20,
        24, (r"\bfixpoint_pass<.*\bLabelndOp\b",)),
    "gossip_value": Kernel(
        kg, "value_flood", kg.value_flood_plain,
        "gseg_tpu_torch/csrc/gossip.cu", _GOSSIP + "_value_step :1120)",
        ALL | DPP | TURBO_NEW | LADDER_T | LADDER_DPP
        | {BSDS["fastmst"], BSDS["superpixel"]} | ALT - set(ALT_GATHER),
        set(), 12, 16, (r"\bfixpoint_pass<.*\bValueOp\b",)),
    "gossip_subsum": Kernel(
        kg, "subtree_sums", kg.subtree_sums_plain,
        "gseg_tpu_torch/csrc/gossip.cu",
        _GOSSIP + "_subsum_step :1157, via subtree_sums :1320)",
        SPEED_SUBSUM | TURBO_NEW | LADDER_T | ALT_SUBSUM, set(), 12, 16,
        (r"\bfixpoint_pass<.*\bSubsumOp\b",)),
    "pad_fields": Kernel(
        kp, "fast_pad_fields", kp.fast_pad_fields_plain,
        "gseg_tpu_torch/csrc/pad.cu",
        "gseg_tpu/ops/pallas/gossip.py:703 (_fast_pad_fields, call :781)",
        {"4k_subsum", "4k_wb16", "4k_fastmst", "4k_batch2", LADDER_RUN}
        | LADDER_WIDE | ALT_4K, set(), None, 0,
        (r"\bpad_fields_(bulk|regs)\b",)),
    "unpad_fields": Kernel(
        kp, "fast_unpad_fields", kp.fast_unpad_fields_plain,
        "gseg_tpu_torch/csrc/pad.cu",
        "gseg_tpu/ops/pallas/gossip.py:799 (_fast_unpad_fields, call :826)",
        {"4k_subsum", "4k_wb16", "4k_fastmst", "4k_batch2", LADDER_RUN}
        | LADDER_WIDE | ALT_4K, set(), None, 0,
        (r"\bunpad_fields_(bulk|regs)\b",)),
    "boundary_extract": Kernel(
        kx, "boundary_extract", kx.boundary_extract_plain,
        "gseg_tpu_torch/csrc/extract.cu",
        "gseg_tpu/ops/pallas/extract.py:344 (_extract_kernel, via "
        "boundary_extract :515)",
        ALL | set(BATCH) | LADDER_T | ALT - {"1080p_spatial4_final_gather"},
        set(), 20, 16, (r"\bextract_(fill|rows)\b",)),
    # a closure "call" below is one rows launch and one columns launch.
    "closure_compmin": Kernel(
        kg, "compmin_closure", kg.compmin_closure_plain,
        "gseg_tpu_torch/csrc/closure.cu",
        _CLOSURE + "_compmin_closure :1031, combine :1020)",
        CLOSURE_MUST, CLOSURE_MAY, 2 * 28, 2 * 20,
        (r"\bclosure_(rows|cols)<.*\bCompminOp\b",)),
    "closure_labelnd": Kernel(
        kg, "labelnd_closure", kg.labelnd_closure_plain,
        "gseg_tpu_torch/csrc/closure.cu",
        _CLOSURE + "_labelnd_closure :1115, combine :1106)",
        CLOSURE_MUST, CLOSURE_MAY, 2 * 20, 2 * 12,
        (r"\bclosure_(rows|cols)<.*\bLabelndOp\b",)),
    "closure_value": Kernel(
        kg, "value_closure", kg.value_closure_plain,
        "gseg_tpu_torch/csrc/closure.cu",
        _CLOSURE + "_value_closure :1141, combine :1135)",
        CLOSURE_MUST, CLOSURE_MAY | {TURBO_HIERARCHY, CLI_LEVEL4},
        2 * 12, 2 * 8, (r"\bclosure_(rows|cols)<.*\bValueOp\b",)),
    "run_extract": Kernel(
        kr, "run_extract", kr.run_extract_plain,
        "gseg_tpu_torch/csrc/runs.cu",
        "gseg_tpu/ops/pallas/extract.py:191 (_runs_kernel, via run_extract "
        ":293, call :315)",
        {"1080p_runs"}, set(), None, 4, (r"\bruns_(rows|fill)\b",)),
    # a helper with no TPU kernel: the superpixel path's colour sums, added
    # in index order as the reference's XLA scatter adds them
    "ordered_scatter_add": Kernel(
        ks, "ordered_scatter_add", ks.ordered_scatter_add_plain,
        "gseg_tpu_torch/csrc/scatter.cu",
        "none: a helper for the XLA scatter-adds of "
        "gseg_tpu/models/superpixel.py:95 and :209",
        set(SUPERPIXEL) | {BSDS["superpixel"]}, set(), None, 1,
        (r"\brun_sums\b",)),
    # stage 2's compact round (no TPU kernel: XLA ops there), on every
    # turbo path (dense, batched, row-sharded, hierarchies) and every
    # fastmst path; a launch is a round the kernel ran. Its bytes are
    # counted from its pool, slots and root map (`_bound`).
    "s2_round": Kernel(
        ks2, "s2_round", ks2.s2_round_plain,
        "gseg_tpu_torch/csrc/s2round.cu",
        "none: a compact round of XLA ops, gseg_tpu/models/turbo.py:777 "
        "(_s2_round)",
        ALL | TURBO_NEW | LADDER_T | LADDER_DPP | ALT | set(FASTMST)
        | {BSDS["fastmst"]}, set(), None, 0,
        (r"\bs2_(minedge|minpos|count|scan|heads|mutual|jump|canon|apply|"
         r"relabel|init)\b",)),
    # the join of the chunk fronts of the chunked pair dedup (no TPU
    # kernel: XLA ops there), on every path through
    # `turbo._chunked_pair_extract`: the DPP paths' handoff (fastmst, its
    # hierarchy, superpixel) and each rank's of the row-sharded turbo path;
    # one launch a call. Its bytes are counted from its output (`_bound`).
    "pair_join": Kernel(
        kpj, "pair_join", kpj.pair_join_plain,
        "gseg_tpu_torch/csrc/pairjoin.cu",
        "none: the output-space scan of gseg_tpu/models/turbo.py:1249 "
        "(_chunked_pair_extract)",
        DPP | LADDER_DPP | {BSDS["fastmst"], BSDS["superpixel"], LADDER_RUN}
        | set(SPATIAL_TURBO) | {"1080p_spatial4_final_gather"}, set(), None,
        0, (r"\bpair_join\b",)),
}
S2 = "s2_round"
PJ = "pair_join"
PADS = ("pad_fields", "unpad_fields")
# the step kernel's wrappers -> their variant in ops/kernels/gossip.py
STEP = {"gossip_compmin": "compmin", "gossip_labeldist": "labeldist",
        "gossip_labelnd": "labelnd", "gossip_value": "value",
        "gossip_subsum": "subsum"}
# Launches of one main-path run of each path (PERF.md §5), with the run
# that first recorded them (stage 2's round: S2_LAUNCHES, merged in
# below); the other kernels launched none. Tile skipping and kernel
# redesigns must leave them as they are.
RECORDED_LAUNCHES = {
    "1080p_subsum": ("4f", dict(
        gossip_compmin=16, gossip_labeldist=8, gossip_labelnd=23,
        gossip_value=17, gossip_subsum=8, boundary_extract=1)),
    "1080p_count": ("4f", dict(
        gossip_compmin=16, gossip_labelnd=31, gossip_value=17,
        boundary_extract=1)),
    "4k_subsum": ("4f", dict(
        gossip_compmin=18, gossip_labeldist=8, gossip_labelnd=21,
        gossip_value=17, gossip_subsum=8, pad_fields=10, unpad_fields=10,
        boundary_extract=1)),
    "1080p_wb16": ("4f", dict(
        gossip_compmin=114, gossip_labelnd=179, gossip_value=46,
        boundary_extract=1)),
    "1080p_wb16_closures": ("4f", dict(
        gossip_compmin=62, gossip_labelnd=108, gossip_value=10,
        boundary_extract=1, closure_compmin=62, closure_labelnd=108,
        closure_value=10)),
    "1080p_runs": ("4f", dict(
        gossip_compmin=16, gossip_labelnd=31, gossip_value=17,
        boundary_extract=1, run_extract=2)),
    # its closures never engage at the default WARM_PASSES
    "4k_wb16": ("6c", dict(
        gossip_compmin=124, gossip_labelnd=196, gossip_value=61,
        pad_fields=18, unpad_fields=18, boundary_extract=1)),
    # the atomic path has no kernel
    "1080p_atomic": ("7b", {}),
    "1080p_atomic_hierarchy": ("7b", {}),
    # stage G as the count peel's; one value flood per distinct stage-2
    # root map and the final map's
    TURBO_HIERARCHY: ("7b", dict(
        gossip_compmin=16, gossip_labelnd=31, gossip_value=153,
        boundary_extract=1)),
    # the DPP paths: value floods over round-1 components (2-3 step passes
    # each, no closure), one per distinct level on the hierarchies; pad and
    # unpad once for the 4K flood; the colour sums once for round 1 and
    # once per compact round that merges
    "1080p_fastmst": ("8a", dict(gossip_value=2)),
    "4k_fastmst": ("8a", dict(gossip_value=3, pad_fields=1, unpad_fields=1)),
    "1080p_fastmst_hierarchy": ("8a", dict(gossip_value=24)),
    "1080p_superpixel": ("8a", dict(gossip_value=3, ordered_scatter_add=4)),
    "1080p_superpixel_hierarchy": ("8a", dict(gossip_value=30,
                                              ordered_scatter_add=11)),
}
# step 10 (run 10a): the batches (summed over their images: image 0's
# launches are those of 1080p_subsum and 4k_subsum), then the slab passes
# of the row-sharded turbo path, summed over the ranks (subtree-sum sizes
# every round, so no label flood; no closure, pad or extract); the
# row-sharded atomic path launches nothing
RECORDED_LAUNCHES |= {
    "1080p_batch4": ("10a", dict(
        gossip_compmin=65, gossip_labeldist=32, gossip_labelnd=81,
        gossip_value=54, gossip_subsum=32, boundary_extract=4)),
    "4k_batch2": ("10a", dict(
        gossip_compmin=37, gossip_labeldist=17, gossip_labelnd=51,
        gossip_value=41, gossip_subsum=17, pad_fields=20, unpad_fields=20,
        boundary_extract=2)),
    "1080p_spatial4": ("10a", dict(
        gossip_compmin=64, gossip_labeldist=136, gossip_value=68,
        gossip_subsum=136)),
    "1080p_spatial4_wb16": ("10a", dict(
        gossip_compmin=456, gossip_labeldist=780, gossip_value=184,
        gossip_subsum=780)),
    "4k_spatial4": ("10a", dict(
        gossip_compmin=72, gossip_labeldist=140, gossip_value=68,
        gossip_subsum=140)),
    "spatial8_short_tiles": ("10a", dict(
        gossip_compmin=72, gossip_labeldist=144, gossip_value=40,
        gossip_subsum=144)),
    "1080p_spatial_atomic4": ("10a", {}),
    "1080p_multichip_2x2": ("10a", {}),
}
# the CLI runs the 1080p default path and the turbo hierarchy; the host
# baseline launches nothing
RECORDED_LAUNCHES[CLI] = RECORDED_LAUNCHES["1080p_subsum"]
RECORDED_LAUNCHES[CLI_LEVEL4] = RECORDED_LAUNCHES[TURBO_HIERARCHY]
RECORDED_LAUNCHES[CLI_NATIVE] = ("9a", {})
# the quality protocol, summed over its 20 images: the turbo hierarchy and
# the quality-mode final map (no hybrid fixpoint reaches the closures),
# the DPP hierarchies' floods and colour sums; the rest launch nothing
RECORDED_LAUNCHES |= {
    BSDS["turbo"]: ("9a", dict(gossip_compmin=294, gossip_labelnd=500,
                               gossip_value=1306, boundary_extract=20)),
    BSDS["turbo_wb16"]: ("9a", dict(gossip_compmin=3184, gossip_labelnd=3758,
                                    gossip_value=347, boundary_extract=20)),
    BSDS["fastmst"]: ("9a", dict(gossip_value=472)),
    BSDS["atomic"]: ("9a", {}),
    BSDS["superpixel"]: ("9a", dict(gossip_value=502,
                                    ordered_scatter_add=196)),
    BSDS["kruskal_native"]: ("9a", {}),
    BSDS["boruvka_cpu"]: ("9a", {}),
}
# step 11: one counted run of each ladder row. The ladder's configuration
# is the main path's (sigma 0.8, k 300, min_size 100, max_iters 32) and its
# images at 1080p and 4K are the main paths', so those rows launch what
# 1080p_subsum / 4k_subsum and 1080p_fastmst / 4k_fastmst launch; the
# atomic path launches nothing; the 540p, 720p and 1440p rows were
# recorded by run 11a.
RECORDED_LAUNCHES |= {p: ("11a", {}) for p, (a, _, _) in LADDER.items()
                      if a == "atomic"}
RECORDED_LAUNCHES |= {
    "ladder_turbo_540x960": ("11a", dict(
        gossip_compmin=14, gossip_labeldist=8, gossip_labelnd=17,
        gossip_value=9, gossip_subsum=8, boundary_extract=1)),
    "ladder_turbo_720x1280": ("11a", dict(
        gossip_compmin=13, gossip_labeldist=8, gossip_labelnd=19,
        gossip_value=10, gossip_subsum=8, boundary_extract=1)),
    "ladder_turbo_1080x1920": RECORDED_LAUNCHES["1080p_subsum"],
    "ladder_turbo_1440x2560": ("11a", dict(
        gossip_compmin=16, gossip_labeldist=8, gossip_labelnd=22,
        gossip_value=16, gossip_subsum=8, pad_fields=10, unpad_fields=10,
        boundary_extract=1)),
    "ladder_turbo_2160x3840": RECORDED_LAUNCHES["4k_subsum"],
    "ladder_fastmst_540x960": ("11a", dict(gossip_value=2)),
    "ladder_fastmst_720x1280": ("11a", dict(gossip_value=2)),
    "ladder_fastmst_1080x1920": RECORDED_LAUNCHES["1080p_fastmst"],
    "ladder_fastmst_1440x2560": ("11a", dict(gossip_value=2, pad_fields=1,
                                             unpad_fields=1)),
    "ladder_fastmst_2160x3840": RECORDED_LAUNCHES["4k_fastmst"],
}
# step 12 (run 12c): the alternatives. The gather drops the value flood
# (and at 4K its pad and unpad), the pointer flood the root-list rounds'
# label floods (and their pads); the unsplit list and the closure switches
# launch what their defaults do (no fixpoint passes the 64 warm passes);
# T = 16 at 4K about halves the step passes; T_SCAN = 4 from the first
# pass takes more closure pairs than 1080p_wb16_closures
RECORDED_LAUNCHES |= {
    "1080p_final_gather": ("12c", dict(
        gossip_compmin=16, gossip_labeldist=8, gossip_labelnd=23,
        gossip_subsum=8, boundary_extract=1)),
    "4k_final_gather": ("12c", dict(
        gossip_compmin=18, gossip_labeldist=8, gossip_labelnd=21,
        gossip_subsum=8, pad_fields=9, unpad_fields=9, boundary_extract=1)),
    "1080p_turbo_hierarchy_final_gather": ("12c", dict(
        gossip_compmin=16, gossip_labelnd=31, boundary_extract=1)),
    "1080p_spatial4_final_gather": ("12c", dict(
        gossip_compmin=64, gossip_labeldist=136, gossip_subsum=136)),
    "1080p_flood_ptr": ("12c", dict(
        gossip_compmin=16, gossip_labeldist=8, gossip_value=17,
        gossip_subsum=8, boundary_extract=1)),
    "4k_flood_ptr": ("12c", dict(
        gossip_compmin=18, gossip_labeldist=8, gossip_value=17,
        gossip_subsum=8, pad_fields=8, unpad_fields=8, boundary_extract=1)),
    "1080p_wb16_rlist_nosplit": RECORDED_LAUNCHES["1080p_wb16"],
    "1080p_late_closures": RECORDED_LAUNCHES["1080p_subsum"],
    "1080p_wb16_no_q_closures": RECORDED_LAUNCHES["1080p_wb16"],
    "4k_t16": ("12c", dict(
        gossip_compmin=11, gossip_labeldist=5, gossip_labelnd=12,
        gossip_value=9, gossip_subsum=5, pad_fields=10, unpad_fields=10,
        boundary_extract=1)),
    "1080p_wb16_closures_tscan4": ("12c", dict(
        gossip_compmin=76, gossip_labelnd=152, gossip_value=12,
        boundary_extract=1, closure_compmin=76, closure_labelnd=152,
        closure_value=12)),
}
CLOSURES = ("closure_compmin", "closure_labelnd", "closure_value")
# closure kernel -> the fixpoint whose fields it is checked and timed at
CLOSURE_OF = {"closure_compmin": "gossip_compmin",
              "closure_labelnd": "gossip_labelnd",
              "closure_value": "gossip_value"}


def _wrapper(name):
    k = KERNELS[name]
    return getattr(k.mod, k.attr)


def _cfg(path):
    return dataclasses.replace(CFG,
                               weight_buckets=PATHS[path].weight_buckets)


def _counts():
    return {name: _wrapper(name).launches for name in KERNELS}


def _axis_counts():
    """Closure launches by orientation: name -> [rows, columns]."""
    return {n: [_wrapper(n).axis_launches[1], _wrapper(n).axis_launches[0]]
            for n in CLOSURES}


def _reset_counts():
    for name in KERNELS:
        _wrapper(name).launches = 0
    for name in CLOSURES:
        _wrapper(name).axis_launches[:] = [0, 0]


@contextlib.contextmanager
def _traced():
    """The program's tracing (`utils.timing`) on for the block, what it
    held before dropped; yields a holder whose `rec` is what the block
    recorded, once the block has ended."""
    holder = types.SimpleNamespace(rec=None)
    timing.take()
    timing.enable()
    try:
        yield holder
    finally:
        timing.disable()
        holder.rec = timing.take()


def _hybrid(rec):
    """(variant, warm step passes, closure pairs) of each fixpoint of a
    record that took the hybrid route: its gseg.fixpoint span's passes
    less the two of each pair."""
    return [(a["variant"], a["passes"] - 2 * a["pairs"], a["pairs"])
            for a in (sp.attrs for sp in rec.spans
                      if sp.name == "gseg.fixpoint") if a["closures"]]


def _tiles(rec):
    """Tiles the step kernel was launched over in a record, per variant:
    [every pass, seeded first passes]."""
    c = rec.counters
    return {v: [c.get(f"tiles.{v}", 0), c.get(f"tiles_seeded.{v}", 0)]
            for v in kg._VARIANTS}


def _event_ms(fn):
    """Milliseconds of one call, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _device_event_ms(fn):
    """Milliseconds of one call on the device: CUDA events around it, with
    the stream held busy (a 0.5 ms device sleep) while the host enqueues
    the call, so the host's launch latency stays out of the reading."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _cuda_ms(fn, reps):
    """Median milliseconds of `reps` calls, CUDA events, after one warm-up
    call."""
    fn()
    return statistics.median(_event_ms(fn) for _ in range(reps))


def _turns_ms(fns, reps):
    """Median CUDA-event milliseconds of each function over `reps` rounds
    of one call each, in an order that reverses every round (ABBA...),
    after one warm-up call each."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for i in range(reps):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            times[j].append(_event_ms(fns[j]))
    return [statistics.median(t) for t in times]


def _profile(fn, calls):
    """key_averages() of `calls` calls after a warm-up call, on the device
    only."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _device_ms(fn, name, calls=3, side=None):
    """Device time (ms) per call of the kernel's own launches, from
    torch.profiler over `calls` calls (side: one alternative of the (a|b)
    group in the kernel's symbols, e.g. "fill" or "rows" of
    boundary_extract, "bulk" or "regs" of a pad route). Raises, listing the
    device kernels the trace holds, when no key matches the kernel's
    symbols in four profiled windows; a window that holds no device time
    at all is logged (cause unknown, PERF.md §7)."""
    pats = [re.compile(re.sub(r"\(\w+\|\w+\)", side, p) if side else p)
            for p in KERNELS[name].symbols]
    seen = set()
    for _ in range(4):
        us = 0.0
        for e in _profile(fn, calls):
            t = getattr(e, "device_time_total", 0)
            if t:
                seen.add(e.key)
            if any(p.search(e.key) for p in pats):
                us += t
        if us:
            return us / 1e3 / calls
        if not seen:
            print(f"profiler window for {name} held no device time; "
                  "profiling again", flush=True)
    raise AssertionError(
        f"{name}: no device time in the profiler trace for "
        f"{KERNELS[name].symbols}; device kernels it holds: {sorted(seen)}")


def _routes_ms(fn, name, calls=10):
    """Device ms per call of each pad route's kernels (csrc/pad.cu:
    "bulk", "regs") in `calls` calls; raises if neither shows in two
    profiled windows."""
    pat = re.compile(KERNELS[name].symbols[0])
    for _ in range(2):
        out = {}
        for e in _profile(fn, calls):
            m = pat.search(e.key)
            if m and e.device_time_total:
                out[m.group(1)] = (out.get(m.group(1), 0.0)
                                   + e.device_time_total / 1e3 / calls)
        if out:
            return out
    raise AssertionError(f"{name}: no route's kernel in the profiler trace")


def _library_device_ms(fn, calls):
    """Device time (ms) per call of every kernel a library call runs; a
    profiled window that holds no device time is logged (cause unknown,
    PERF.md §7) and profiled again, up to four windows."""
    for _ in range(4):
        us = sum(e.self_device_time_total for e in _profile(fn, calls))
        if us:
            return us / 1e3 / calls
        print("profiler window for a library call held no device time; "
              "profiling again", flush=True)
    raise AssertionError("no device time in the library call's trace")


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


def _runs_multiset(res, cap):
    """The run pool as a sorted multiset of (label, length), its exact count
    and overflow flag; on overflow only the count of filled slots (which
    pairs land below the capacity depends on launch order)."""
    lab, cnt, count, ovf = res
    head = torch.tensor([float(count), float(bool(ovf))], dtype=torch.float64)
    if bool(ovf):
        filled = float((lab != kr.INT32_MAX).sum())
        return [head, torch.tensor([filled], dtype=torch.float64)]
    n = int(count)
    keys = torch.stack([lab[:n].double(), cnt[:n].double()], 1).cpu().numpy()
    dead = bool((lab[n:] == kr.INT32_MAX).all() and (cnt[n:] == 0).all())
    return [head, torch.from_numpy(keys[np.lexsort(keys.T[::-1])]),
            torch.tensor([float(dead)], dtype=torch.float64)]


def _compare(name, args, kwargs=None):
    """Run the kernel wrapper and the plain version on the same CUDA
    tensors (closures: both orientations); returns the max abs error (0.0:
    equal)."""
    kwargs = kwargs or {}
    plain = KERNELS[name].plain
    if name in CLOSURES:
        err = 0.0
        for axis in (1, 0):
            kout, pout = _wrapper(name)(*args, axis), plain(*args, axis)
            torch.cuda.synchronize()
            if kout[-1] != pout[-1]:
                raise AssertionError(f"{name} axis {axis}: changed flags "
                                     f"differ ({kout[-1]} vs {pout[-1]})")
            err = max(err, _max_abs_err(kout[:-1], pout[:-1]))
        return err
    kernel_out = _wrapper(name)(*args, **kwargs)
    plain_out = plain(*args, **kwargs) if name == S2 else plain(*args)
    torch.cuda.synchronize()
    if name == "boundary_extract":
        return _max_abs_err(_pool_multiset(kernel_out),
                            _pool_multiset(plain_out))
    if name == "run_extract":
        return _max_abs_err(_runs_multiset(kernel_out, args[1]),
                            _runs_multiset(plain_out, args[1]))
    if name in PADS:
        return _max_abs_err(kernel_out, plain_out)
    if name == "ordered_scatter_add":
        return _max_abs_err((kernel_out,), (plain_out,))
    if name in (S2, PJ):   # every output, flags and overflow included
        return _max_abs_err(kernel_out, plain_out)
    if kernel_out[-1] or plain_out[-1]:
        raise AssertionError(f"{name}: a fixpoint hit its sweep cap")
    return _max_abs_err(kernel_out[:-1], plain_out[:-1])


def _kernel_fn(name, args, kwargs=None):
    """One call of the kernel wrapper (closures: a rows and a columns
    launch)."""
    fn, kwargs = _wrapper(name), kwargs or {}
    if name in CLOSURES:
        return lambda: (fn(*args, 1), fn(*args, 0))
    return lambda: fn(*args, **kwargs)


def _plain_fn(name, args, kwargs=None):
    fn = KERNELS[name].plain
    if name in CLOSURES:
        return lambda: (fn(*args, 1), fn(*args, 0))
    if name == S2:   # the round's settings are keywords
        return lambda: fn(*args, **kwargs)
    return lambda: fn(*args)


def _library_call(name, args):
    """One PyTorch call per field computing the same function as the
    kernel, where one exists (timed as a yardstick only). For run_extract:
    the counting `bincount` of the sizes step it feeds."""
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
    if name == "run_extract":
        L = args[0]
        return lambda: torch.bincount(L.reshape(-1).long(),
                                      minlength=L.numel())
    if name == "ordered_scatter_add":
        # index_add_ (atomics, in no fixed order) into a base one row
        # longer, the dropped targets sent to that row
        base, idx, vals = args
        v = base.shape[0]
        ext = torch.cat([base, base.new_zeros(1, base.shape[1])])
        safe = torch.where((idx >= 0) & (idx < v), idx, v).long()
        return lambda: ext.clone().index_add_(0, safe, vals)
    return None


def _bound(name, args):
    """Least time in ms for the card to do one call's work: one read of
    every input and one write of every output at the HBM rate, or the
    operations at the float32 rate, whichever is larger."""
    k = KERNELS[name]
    if name == "pad_fields":
        fields, t, hp, wp = args
        nbytes = sum(4 * (x.numel() + (hp + 2 * t) * wp) for x, _ in fields)
        npx = 0
    elif name == "unpad_fields":
        fields, t, h, w = args
        nbytes = 2 * 4 * h * w * len(fields)
        npx = 0
    elif name == "run_extract":
        L, cap = args
        npx = L.numel()
        nbytes = 4 * npx + 8 * min(int(kr.run_extract_plain(L, cap)[2]), cap)
    elif name == "ordered_scatter_add":
        base, idx, vals = args  # one add per float of every update
        npx = vals.numel()
        nbytes = (idx.element_size() * idx.numel() + 4 * vals.numel()
                  + 2 * 4 * base.numel())
    elif name == S2:
        # one read of the pool (esrc, edst, ew, eeid: 16 B an entry), the
        # slots (SZf, IDf: 8 B) and the root map; one write of esrc and
        # edst, the slots and the root map
        esrc, _, _, _, SZf, _, fin, _ = args
        npx = esrc.numel()
        nbytes = 24 * npx + 16 * SZf.numel() + 8 * fin.numel()
    elif name == PJ:
        # a slot's perm entry (8 B) and its four words (16 B) read once, the
        # mask and four words (17 B) written once; the counts read once
        counts, pair_cap = args[0], args[-1]
        npx = pair_cap
        nbytes = 41 * pair_cap + 8 * counts.numel()
    else:
        npx = args[0].numel()
        nbytes = k.bytes_px * npx
        if name == "boundary_extract":
            nbytes += 16 * int(kx.boundary_extract_plain(*args)[4])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = k.ops_px * npx / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _same_label_pdir(L, seed):
    """BFS levels from sparse random seeds over same-label adjacency (plain
    flood) and the parent directions of that forest: a consistent pdir."""
    h, w = L.shape
    g = torch.Generator(device=L.device).manual_seed(seed)
    seeds = torch.rand((h, w), generator=g, device=L.device) < 0.05
    dist0 = torch.full((h, w), kg.BIGDIST, dtype=torch.int32,
                       device=L.device).masked_fill(seeds, 0)
    _, _, dist, unconv = kg.label_gossip_plain(
        _same_bits(L), L, torch.zeros((h, w), device=L.device), dist0,
        4 * (h + w))
    if unconv:
        raise AssertionError("BFS for the subsum check did not converge")
    return dist0, turbo._parent_dirs(L, dist)


def _same_bits(L):
    """Packed allow bits of same-label adjacency."""
    return kg.pack_allow_bits([gg.shift_plane(L, dy, dx, -1) == L
                               for dy, dx in gg.DIRS8])


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
        "closure_compmin": (L, bw, be, sz),
        "closure_labelnd": (allow, be, bw),
        "closure_value": (L, be),
        "run_extract": (L, h * w),
        "ordered_scatter_add": _scatter_args(rng, h * w, dev),
        "pair_join": _pair_join_args(rng, h * w, dev),
    }


def _pair_join_args(rng, n, dev):
    """A join of 4n slots as the dedup hands them over, at the pair cap
    1.25 n: chunks of 64 slots (over 256 chunks: several counts a scanning
    thread), or of the dedup's 131072 past 8192 such chunks; per chunk up
    to half its slots heads (some chunks none) and a random permutation."""
    slots = 4 * n
    chunk = 64 if slots <= 64 * kpj.MAX_CHUNKS else turbo.PAIR_CHUNK
    nch = -(-slots // chunk)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    counts = torch.randint(0, chunk // 2 + 1, (nch,), generator=g,
                           device=dev)
    counts[torch.rand(nch, generator=g, device=dev) < 0.1] = 0
    perm = torch.argsort(torch.rand((nch, chunk), generator=g, device=dev),
                         dim=1)
    words = [torch.randint(0, 2**31 - 1, (nch * chunk,), generator=g,
                           device=dev, dtype=torch.int32) for _ in range(3)]
    w = torch.rand(nch * chunk, generator=g, device=dev)
    return (counts, perm, words[0], words[1], w, words[2],
            max(5 * n // 4, 1))


def _join_checks(path, run, overflow=False):
    """Every call of the join in run() (each rank's on a row-sharded path)
    against the plain version: every lane, masked lanes and the overflow
    flag; with `overflow` also at half the heads as the pair cap. Returns
    (the calls' arguments, max abs error)."""
    calls = [a for a, _ in _wrapper_calls([PJ], run)[PJ]]
    if not calls:
        raise AssertionError(f"{path}: the join never ran")
    err = 0.0
    for args in calls:
        err = max(err, _compare(PJ, args))
        if overflow:
            cap = max(int(args[0].sum()) // 2, 1)
            err = max(err, _compare(PJ, args[:-1] + (cap,)))
    print(f"check {PJ} {path}: {len(calls)} calls (pair caps "
          f"{[a[-1] for a in calls]}, chunks "
          f"{[tuple(a[1].shape) for a in calls]}) equal to plain in every "
          "lane and the overflow flag"
          + ("; each also at half its heads (overflow)" if overflow else ""),
          flush=True)
    return calls, err


def _scatter_args(rng, n, dev):
    """n row updates of 3 floats into n // 4 + 1 slots: a third of them
    into 1% of the slots (long runs), some dropped (past the end or
    negative)."""
    v = n // 4 + 1
    idx = rng.integers(-2, v + 3, n).astype(np.int32)
    idx[: n // 3] = rng.integers(0, max(v // 100, 1), n // 3)
    return (torch.from_numpy(rng.uniform(0, 255, (v, 3)).astype(
        np.float32)).to(dev), torch.from_numpy(idx).to(dev),
        torch.from_numpy(rng.uniform(0, 1e4, (n, 3)).astype(
            np.float32)).to(dev))


def _serpentine(h, w, lanes=3, thick=3, margin=100):
    """Label 1 on a serpentine of `lanes` horizontal lanes joined at
    alternating ends, label 0 elsewhere."""
    L = np.zeros((h, w), np.int32)
    ys = np.linspace(margin, h - margin - thick, lanes).astype(int)
    x0, x1 = margin, w - margin - thick
    for i, y in enumerate(ys):
        L[y:y + thick, x0:x1 + thick] = 1
        if i + 1 < lanes:
            x = x1 if i % 2 == 0 else x0
            L[y:ys[i + 1] + thick, x:x + thick] = 1
    return L


def _eccentricity(L, label):
    """BFS depth over 8-adjacency from the component's first pixel (an end
    of the serpentine, so this is its geodesic diameter)."""
    h, w = L.shape
    ys, xs = np.nonzero(L == label)
    start = (int(ys[0]), int(xs[0]))
    dist = {start: 0}
    queue = collections.deque([start])
    while queue:
        y, x = queue.popleft()
        for dy, dx in gg.DIRS8:
            n = (y + dy, x + dx)
            if 0 <= n[0] < h and 0 <= n[1] < w and L[n] == label \
                    and n not in dist:
                dist[n] = dist[(y, x)] + 1
                queue.append(n)
    return max(dist.values())


def _serpentine_check(dev, card):
    """Closure-route fixpoints at the default WARM_PASSES on a 1081x1919
    serpentine: each must equal its plain fixpoint and launch its closure
    kernel in both orientations. Returns name -> max abs error."""
    h, w = SERPENTINE
    Ln = _serpentine(h, w)
    diam = _eccentricity(Ln, 1)
    if not 1000 < diam < 8000 or not 8 * kg.WARM_PASSES < diam:
        raise AssertionError(f"serpentine geodesic diameter {diam} px")
    rng = np.random.default_rng(17)

    def t(x):
        return torch.from_numpy(x).to(dev)

    L = t(Ln)
    cases = {
        "gossip_compmin": (L, t(rng.uniform(0, 1, (h, w)).astype(np.float32)),
                           t(rng.integers(0, 1 << 30, (h, w)).astype(np.int32)),
                           t(rng.integers(1, 9, (h, w)).astype(np.int32))),
        "gossip_labelnd": (_same_bits(L),
                           t(rng.integers(0, 1 << 30, (h, w)).astype(np.int32)),
                           t(rng.uniform(0, 5, (h, w)).astype(np.float32))),
        "gossip_value": (L, t(rng.integers(0, 1 << 30, (h, w)).astype(np.int32))),
    }
    errs = {}
    for name, args in cases.items():
        closure = next(c for c, f in CLOSURE_OF.items() if f == name)
        before = list(_wrapper(closure).axis_launches)
        t0 = time.perf_counter()
        with _traced() as traced:
            errs[name] = _compare(name, (*args, 4 * (h + w)),
                                  {"closures": True})
        after = _wrapper(closure).axis_launches
        if not (after[0] > before[0] and after[1] > before[1]):
            raise AssertionError(f"serpentine {name}: closure launches "
                                 f"{before} -> {after} (columns, rows)")
        errs[closure] = _compare(closure, args)
        print(f"check {name} closures=True serpentine {h}x{w} (geodesic "
              f"diameter {diam} px): equal to plain; hybrid "
              f"(variant, step passes, pairs) {_hybrid(traced.rec)}, closure "
              f"launches rows {after[1] - before[1]} columns "
              f"{after[0] - before[0]}; check took "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return errs


def _clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x) for x in a)
    return a


def _wrapper_calls(names, run, first_only=False):
    """Run run() once, recording every real call (idle ones left out) of
    each named kernel wrapper, or with `first_only` its first one. Returns
    name -> [(args, kwargs), ...]."""
    calls = {name: [] for name in names}
    originals = {name: _wrapper(name) for name in names}

    def recorder(name):
        fn = originals[name]

        def rec(*args, **kwargs):
            if not kwargs.get("idle", False) and not (first_only
                                                      and calls[name]):
                calls[name].append((_clone(args),
                                    {k: v for k, v in kwargs.items()
                                     if k != "idle"}))
            return fn(*args, **kwargs)
        return rec

    for name in names:
        setattr(KERNELS[name].mod, KERNELS[name].attr, recorder(name))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(KERNELS[name].mod, KERNELS[name].attr, fn)
    return calls


def _capture_main_path_fields(image, cfg):
    """Run the turbo main path once, recording each wrapper's first real
    call (compmin's first non-idle one; stage 2's first round, in root
    space). Returns name -> (args, kwargs)."""
    calls = _wrapper_calls(
        [n for n in KERNELS if n not in CLOSURES],
        lambda: turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS),
        first_only=True)
    return {name: c[0] for name, c in calls.items() if c}


def _stage_split(image, cfg, reps):
    """Median ms of each main-path stage, run in sequence as
    segment_turbo_impl runs them."""
    h, w = image.shape[:2]
    v = h * w
    quality = cfg.weight_buckets > 0
    out = {}

    def weights():
        sm = filters.gaussian_smooth(image, cfg.sigma)
        return gg.edge_weight_planes(sm, cfg.connectivity,
                                     cfg.quantize_weight_bits)[0]

    wts = weights()
    gst, _, thr = turbo._stage_g(image, cfg, GOSSIP_ROUNDS, wts)
    st, rm, r0 = turbo._extract_stage(gst, wts, cfg)
    st2 = turbo._s2_stage(st, v, cfg, thr, r0)
    out["weights"] = _cuda_ms(weights, reps)
    out["stage_g"] = _cuda_ms(
        lambda: turbo._stage_g(image, cfg, GOSSIP_ROUNDS, wts), reps)
    out["handoff"] = _cuda_ms(lambda: turbo._extract_stage(gst, wts, cfg),
                              reps)
    out["stage_2"] = _cuda_ms(
        lambda: turbo._s2_stage(st, v, cfg, thr, r0), reps)
    out["final_map"] = _cuda_ms(
        lambda: turbo._final_map(gst, st2, rm, r0, 4 * (h + w),
                                 closures=quality), reps)
    out["rounds_stage_g"] = gst.it
    out["rounds_stage_2"] = st2.it
    return out


def _check_oracle(labels, image, path, cfg):
    got = canonical_min_labels_np(labels.cpu().numpy())
    oracle = load_oracle(path)
    ndiff = int((got != oracle).sum())
    print(f"  oracle partition ({path.relative_to(ROOT)}): {ndiff} pixels "
          "differ "
          f"({len(np.unique(got))} components, oracle "
          f"{len(np.unique(oracle))})", flush=True)
    if ndiff:
        # tell a filter-drift near-tie apart from a kernel fault
        cpu_w, _ = gg.edge_weight_planes(
            filters.gaussian_smooth(image.cpu(), cfg.sigma),
            cfg.connectivity, cfg.quantize_weight_bits)
        lab2, fl2 = turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS,
                                                weights_override=cpu_w)
        nd2 = int((canonical_min_labels_np(lab2.cpu().numpy())
                   != oracle).sum())
        print(f"  rerun with CPU-filter weights: flags {fl2}, {nd2} pixels "
              "differ from the oracle", flush=True)
        raise AssertionError("main path partition differs from the oracle")


def _run_path(path, image, card):
    """The counted main-path run of one path, its checks and its times.
    Returns a record of launches, main-path ms, stage split, peak MiB and,
    on the quality paths, the closure launches and hybrid fixpoints."""
    P = PATHS[path]
    cfg = _cfg(path)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with _traced() as traced:
        labels, flags = turbo.segment_turbo_flagged(image, cfg,
                                                    GOSSIP_ROUNDS)
        torch.cuda.synchronize()
    launches, axis = _counts(), _axis_counts()
    hybrid = _hybrid(traced.rec)
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"main path {path}: flags {flags} ({turbo.describe_flags(flags)}),"
          f" launches {launches}, peak memory {peak:.1f} MiB", flush=True)
    rec = {"launches": launches, "peak_mib": peak}
    if path in QUALITY:
        rec["closure_launches_rows_cols"] = axis
        rec["hybrid_variant_steps_pairs"] = hybrid
        print(f"  closure launches (rows, columns) {axis}; "
              f"{len(hybrid)} hybrid fixpoints, "
              f"{sum(p > 0 for _, _, p in hybrid)} with a phase 2, "
              f"(variant, step passes, phase-2 pairs) each: {hybrid}",
              flush=True)
    if flags != 0:
        raise AssertionError(f"{path}: main path raised flags {flags}")
    _check_path_launches(path, launches)
    one_way = [n for n in CLOSURES if path in KERNELS[n].must
               and min(axis[n]) == 0]
    if one_way:
        raise AssertionError(f"{path}: {one_way} did not launch in both "
                             "orientations")
    _check_oracle(labels, image, P.oracle, cfg)
    reps = 9 if P.h * P.w < 4_000_000 and path not in QUALITY else 5
    rec["main_ms"] = _cuda_ms(
        lambda: turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS), reps)
    print(f"  main path {path}: median {rec['main_ms']:.3f} ms of {reps} "
          f"reps = {P.h * P.w / 1e6 / (rec['main_ms'] / 1e3):.2f} MPix/s "
          f"({card})", flush=True)
    rec["stages_ms"] = split = _stage_split(image, cfg, 3)
    print("  stage split (median ms of 3): " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in split.items()) + f" ({card})", flush=True)
    return rec


def _peel_ab(image, card, pairs=4):
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
    out = {k: {"median": statistics.median(v), "ms": v}
           for k, v in times.items()}
    print(f"peel A/B 1080p, {pairs} alternating pairs: subsum median "
          f"{out['subsum']['median']:.3f} ms {times['subsum']}, count median "
          f"{out['count']['median']:.3f} ms {times['count']}; subsum faster "
          f"in {wins} of {pairs} pairs ({card})", flush=True)
    return out


def _offset(x):
    """A contiguous copy of x whose data starts one word past a 16-byte
    boundary: csrc/pad.cu's alignment test sends it to the register
    route."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _offset_args(name, args):
    if name == "pad_fields":
        fields, t, hp, wp = args
        return ([(_offset(x), f) for x, f in fields], t, hp, wp)
    fields, t, h, w = args
    return ([_offset(x) for x in fields], t, h, w)


def _pad_routes(name, args, rec):
    """Both pad routes at one call's aligned planes: the call as given (the
    bulk route) and on copies offset by one word (the register route).
    Checks each against the plain version and that it ran its route's
    kernel alone; adds their device ms, the register route's call ms and
    the bulk route's device ms with the L2 cache flushed (a 256 MB read)
    before each call to rec. Returns a note for the log."""
    off = _offset_args(name, args)
    rec["max_abs_err"] = max(rec["max_abs_err"], _compare(name, off))
    for route, a in (("bulk", args), ("regs", off)):
        taken = _routes_ms(_kernel_fn(name, a), name)
        if set(taken) != {route}:
            raise AssertionError(f"{name}: ran routes {sorted(taken)} where "
                                 f"{route} alone was due")
        rec[f"device_ms_{route}"] = taken[route]
    rec["ms_regs"] = _cuda_ms(_kernel_fn(name, off), 21)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    call = _kernel_fn(name, args)
    rec["device_ms_bulk_cold"] = _routes_ms(
        lambda: (flush.sum(), call()), name)["bulk"]
    return (f": bulk route {rec['device_ms_bulk']:.4f}, L2 flushed "
            f"{rec['device_ms_bulk_cold']:.4f}; register route on planes "
            f"offset by one word {rec['device_ms_regs']:.4f}, call "
            f"{rec['ms_regs']:.4f} ms")


def _step_call(name, kfn, rec, calls):
    """The device time of one fixpoint call with TILE_SKIP off, and the
    share of its tiles that the gated call computed (device counter).
    Returns a note for the log."""
    skip = kg.TILE_SKIP
    kg.TILE_SKIP = False
    try:
        rec["device_ms_ungated"] = _device_ms(kfn, name, calls)
    finally:
        kg.TILE_SKIP = skip
    kg.reset_tile_counts()
    with _traced() as traced:
        kfn()
        torch.cuda.synchronize()
    v = STEP[name]
    c0, c1, steps = kg.tile_counts()[v]
    rec["tile_share_call"] = (c0 + c1) / _tiles(traced.rec)[v][0]
    rec["steps_per_tile_call"] = steps / (c0 + c1)
    p = rec["passes"]
    return (f": per launch gated {rec['device_ms'] / p:.4f}, ungated "
            f"{rec['device_ms_ungated'] / p:.4f} (call "
            f"{rec['device_ms_ungated']:.4f}); tiles computed gated "
            f"{rec['tile_share_call']:.4f}, {rec['steps_per_tile_call']:.2f} "
            "in-tile steps each")


def _pass_times(name, args, kwargs, card):
    """The fixpoint pass by pass, gated and ungated: each pass's tiles
    computed, in-tile steps run (device counters) and its device ms
    (_device_event_ms around the one launch), and a least-squares fit
    ms = a + b x tiles over both runs' passes. Returns the record."""
    v = STEP[name]
    ro, *fields, ms = args
    seed = kwargs.get("seed_mask")
    h, w = ro.shape
    tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
    stream = torch.cuda.current_stream().cuda_stream
    rec = {}
    for gate in (True, False):
        bufs = [[torch.empty_like(x) for x in fields] for _ in range(2)]
        acts = [torch.empty(tiles, dtype=torch.uint8, device=ro.device)
                for _ in range(2)]
        changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
        passes = []

        def step(src, dst, act_in, act_out):
            kg.reset_tile_counts()
            t = _device_event_ms(lambda: kg._launch_pass(
                v, ro, src, dst, act_in, act_out, changed, stream,
                kg.STEPS))
            c0, c1, steps = kg.tile_counts()[v]
            passes.append((c0 + c1, steps, t))

        seed_act = None if seed is None else kg._seed_act(seed, h, w, 0)
        cap = -(-ms // kg.STEPS)
        kg._pass_loop(step, None, fields, bufs, acts, changed, cap, cap,
                      seed_act, gate)
        rec["gated" if gate else "ungated"] = passes
    pts = np.array([(n, t) for p in rec.values() for n, _, t in p], float)
    b, a = np.polyfit(pts[:, 0], pts[:, 1], 1)
    rec["fit_ms"] = {"a": a, "b_per_tile": b}
    print(f"  {name} pass by pass (tiles computed, in-tile steps, ms): gated "
          f"{[(n, s, round(t, 4)) for n, s, t in rec['gated']]}, ungated "
          f"{[(n, s, round(t, 4)) for n, s, t in rec['ungated']]}; fit ms = "
          f"{a:.4f} + {b * 1e3:.4f}e-3 x tiles ({card})", flush=True)
    return rec


def _closure_launch_ms(name, args, axis, reps=5):
    """Device ms of one closure launch along `axis` (median of `reps`, CUDA
    events behind a device sleep, after a warm-up), each on fresh copies of
    the fields, so every launch does the same work."""
    variant = STEP[CLOSURE_OF[name]]
    ro, *fields = args
    lib = kg._closure_lib()
    changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for _ in range(reps + 1):
        f = [x.clone() for x in fields]
        times.append(_device_event_ms(lambda: kg._closure_launch(
            variant, lib, ro, f, axis, changed, stream)))
    return statistics.median(times[1:])


def _closure_split(name, args, rec):
    """A closure's rows and columns launches' device ms. Returns a note for
    the log."""
    for axis, side in ((1, "rows"), (0, "cols")):
        rec[f"device_ms_{side}"] = _closure_launch_ms(name, args, axis)
    return (f": rows {rec['device_ms_rows']:.4f}, columns "
            f"{rec['device_ms_cols']:.4f} (one launch each, CUDA events)")


def _padded_closure_fields(fields):
    """Each closure's arguments as the padded route gives them at w >=
    PAD_MIN_WIDTH: its fixpoint's captured input planes padded to (hp +
    2T, wp) with the inert fills."""
    out = {}
    for c, f in CLOSURE_OF.items():
        ro, *planes, _ = fields[f][0]
        _, ro_fill, fills = kg._VARIANTS[STEP[f]]
        h, w = ro.shape
        hp = -(-h // kg._TILE) * kg._TILE
        wp = -(-w // kg._PAD_LANES) * kg._PAD_LANES
        out[c] = (tuple(kp.fast_pad_fields(
            [(ro, ro_fill), *zip(planes, fills)], kg.STEPS, hp, wp)), {})
    return out


def _closure_route_check(fields, path, errs):
    """Each closure-route fixpoint at a path's captured fields with
    WARM_PASSES 0 (closures from the first pass) against its plain
    fixpoint; raises the entries of errs."""
    warm = kg.WARM_PASSES
    kg.WARM_PASSES = 0
    try:
        for f in CLOSURE_OF.values():
            with _traced() as traced:
                errs[f] = max(errs[f], _compare(f, *fields[f]))
            print(f"check {f} {path} main-path fields closures=True "
                  f"WARM_PASSES=0: equal to plain; hybrid (variant, step "
                  f"passes, pairs) {_hybrid(traced.rec)}", flush=True)
    finally:
        kg.WARM_PASSES = warm


def _time_kernels(fields, label, card, plain_reps):
    """Check and time each kernel call: kernel ms (median of 5; of 21 in
    turns with the library call where one exists), plain ms, library ms
    (call and device), bound ms, device ms (pad/unpad: of both routes, over
    10 profiled calls) and launches per call."""
    out = {}
    for name, (args, kwargs) in fields.items():
        err = _compare(name, args, kwargs)
        kfn = _kernel_fn(name, args, kwargs)
        before = _wrapper(name).launches
        kfn()
        passes = _wrapper(name).launches - before
        calls = 10 if name in PADS else 3
        rec = {"max_abs_err": err, "passes": passes,
               "plain_ms": _cuda_ms(_plain_fn(name, args, kwargs),
                                    plain_reps)}
        lib = _library_call(name, args)
        if lib:
            rec["ms"], rec["library_ms"] = _turns_ms([kfn, lib], 21)
            rec["library_device_ms"] = _library_device_ms(lib, calls)
        else:
            rec["ms"], rec["library_ms"] = _cuda_ms(kfn, 5), None
        rec["bound_ms"], rec["bound_by"] = _bound(name, args)
        rec["device_ms"] = _device_ms(kfn, name, calls)
        split = _pad_routes(name, args, rec) if name in PADS else ""
        if name in STEP:
            split = _step_call(name, kfn, rec, calls)
            rec["pass_fit_ms"] = _pass_times(name, args, kwargs,
                                             card)["fit_ms"]
        if name in CLOSURES:
            split = _closure_split(name, args, rec)
        if name in ("boundary_extract", "run_extract"):
            for side in ("fill", "rows"):
                rec[f"device_ms_{side}"] = _device_ms(kfn, name, calls, side)
            split = (f": fill {rec['device_ms_fill']:.4f}, rows "
                     f"{rec['device_ms_rows']:.4f}")
        if name == "run_extract":
            L, cap = args
            rec["pairs"] = int(kr.run_extract_plain(L, cap)[2])
            rec["cap"] = cap
            rec["fill_bytes"] = 8 * max(cap - rec["pairs"], 0)
            split += (f"; {rec['pairs']} pairs, cap {cap}: the sentinel fill "
                      f"writes {rec['fill_bytes']} B past the count, outside "
                      "the bound")
        out[name] = rec
        print(f"check {name} {label}: equal to plain; "
              f"kernel {rec['ms']:.3f} ms ({passes} launches; on the device"
              f" {rec['device_ms']:.4f} ms{split}), plain "
              f"{rec['plain_ms']:.3f} ms, library "
              + (f"{rec['library_ms']:.3f} ms (on the device "
                 f"{rec['library_device_ms']:.4f} ms)" if lib else "none")
              + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) "
              f"({card})", flush=True)
    return out


def _gated_passes(name, args, kwargs=None, t=None, ref=None):
    """One fixpoint driven pass by pass through the pass loop with tile
    skipping, each pass of t steps (default kg.STEPS) by the kernel
    (kg.step_pass) and by kg.step_pass_plain from the same input into
    copies of the same destination: fields, act_out and changed must agree
    after every pass, and the result must equal the plain fixpoint (ref:
    its outputs, if already computed). A seed_mask in kwargs seeds the
    first pass. Returns (passes, max abs error)."""
    t = t or kg.STEPS
    v = STEP[name]
    ro, *fields, ms = args
    seed = (kwargs or {}).get("seed_mask")
    h, w = ro.shape
    tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
    bufs = [[torch.zeros_like(x) for x in fields] for _ in range(2)]
    acts = [torch.zeros(tiles, dtype=torch.uint8, device=ro.device)
            for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
    err = 0.0

    def step(src, dst, act_in, act_out):
        nonlocal err
        pdst = [x.clone() for x in dst]
        _, ka, kc = kg.step_pass(v, ro, src, dst, act_in, t)
        _, pa, pc = kg.step_pass_plain(v, ro, src, pdst, act_in, t)
        if kc != pc:
            raise AssertionError(f"{name} step pass: changed {kc} vs plain "
                                 f"{pc}")
        err = max(err, _max_abs_err(dst, pdst), _max_abs_err([ka], [pa]))
        act_out.copy_(ka)
        if kc:
            changed.fill_(1)

    seed_act = None if seed is None else kg._seed_act(seed, h, w, 0)
    cap = -(-ms // t)
    out, unconv, n, _ = kg._pass_loop(step, None, fields, bufs, acts,
                                      changed, cap, cap, seed_act, True)
    ref = ref or KERNELS[name].plain(*args)
    if unconv or ref[-1]:
        raise AssertionError(f"{name}: a fixpoint hit its cap")
    return n, max(err, _max_abs_err(out, ref[:-1]))


def _check_launches(path, launches):
    run, recorded = RECORDED_LAUNCHES[path]
    want = {n: recorded.get(n, 0) for n in KERNELS}
    if path in S2_UNSETTLED:   # any number of rounds, but some
        want[S2] = max(launches[S2], 1)
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, run {run}'s "
                             f"{want}")


def _check_path_launches(path, launches):
    """The recorded launches, a launch of every kernel the path must run
    and none of a kernel it must not run."""
    _check_launches(path, launches)
    _check_kernels_run(path, launches)


def _check_kernels_run(path, launches):
    """A launch of every kernel the path must run and none of a kernel it
    must not run."""
    idle = [n for n in KERNELS if path in KERNELS[n].must
            and launches[n] == 0]
    if idle:
        raise AssertionError(f"{path}: main path never launched {idle}")
    stray = [n for n in KERNELS if path not in KERNELS[n].must
             and path not in KERNELS[n].may and launches[n]]
    if stray:
        raise AssertionError(f"{path}: main path launched {stray}, which "
                             "it must not run")


def _step_run(image, cfg):
    """One main-path run under the profiler: (labels, flags, launches, the
    step kernel's device ms per wrapper, tiles computed per variant
    (unseeded, seeded first passes), tiles launched per variant (all,
    seeded first passes))."""
    _reset_counts()
    kg.reset_tile_counts()
    torch.cuda.synchronize()
    with _traced() as traced, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        labels, flags = turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS)
        torch.cuda.synchronize()
    pats = {n: re.compile(KERNELS[n].symbols[0]) for n in STEP}
    ms = dict.fromkeys(STEP, 0.0)
    for e in prof.key_averages():
        for n, pat in pats.items():
            if pat.search(e.key):
                ms[n] += e.device_time_total / 1e3
    return (labels, flags, _counts(), ms, kg.tile_counts(),
            _tiles(traced.rec))


def _step_ab(path, image, card):
    """The step kernel's device time over one whole main-path run with
    TILE_SKIP on and off in turns (on, off, off, on), the active-tile share
    of the gated runs from the device counter, and the bound of the tiles
    each computed. Every run must give the same labels, flags 0 and the
    recorded launches. Returns the record for the paths line."""
    cfg = _cfg(path)
    runs = {True: [], False: []}
    skip = kg.TILE_SKIP
    try:
        for on in (True, False, False, True):
            kg.TILE_SKIP = on
            runs[on].append(_step_run(image, cfg))
    finally:
        kg.TILE_SKIP = skip
    ref = runs[True][0][0]
    for r in runs[True] + runs[False]:
        if r[1] != 0 or not torch.equal(r[0], ref):
            raise AssertionError(f"{path}: gated and ungated runs differ "
                                 f"(flags {r[1]})")
        _check_launches(path, r[2])
    rec = {}
    for on, key in ((True, "gated"), (False, "ungated")):
        rec[f"step_device_ms_{key}"] = [sum(r[3].values()) for r in runs[on]]
        rec[f"step_device_ms_{key}_by_kernel"] = {
            n: statistics.mean(r[3][n] for r in runs[on]) for n in STEP}
    tiles, launched = runs[True][0][4], runs[True][0][5]
    if any(r[4] != tiles or r[5] != launched for r in runs[True]):
        raise AssertionError(f"{path}: the gated runs computed different "
                             "tiles")
    by = {}
    for n, v in STEP.items():
        (c0, c1, steps), (l0, l1) = tiles[v], launched[v]
        if l0:
            by[n] = {"computed": c0 + c1, "launched": l0,
                     "steps_per_tile": steps / (c0 + c1),
                     "computed_first_full": c0 + l1,
                     "share_first_full": (c0 + l1) / l0,
                     "seed_saved": l1 - c1}
    c0 = sum(tiles[v][0] for v in STEP.values())
    c1 = sum(tiles[v][1] for v in STEP.values())
    l0 = sum(launched[v][0] for v in STEP.values())
    l1 = sum(launched[v][1] for v in STEP.values())
    tile_px = kg._TILE ** 2

    def bound(count):
        return sum(count(STEP[n]) * tile_px * KERNELS[n].bytes_px
                   for n in STEP) / HBM_BYTES_PER_S * 1e3

    rec |= {"active_share_first_full": (c0 + l1) / l0,
            "active_share": (c0 + c1) / l0, "tiles_launched": l0,
            "seed_tiles_saved": l1 - c1, "active_by_kernel": by,
            "step_bound_ms_gated": bound(lambda v: sum(tiles[v][:2])),
            "step_bound_ms_ungated": bound(lambda v: launched[v][0])}
    gated = statistics.mean(rec["step_device_ms_gated"])
    ungated = statistics.mean(rec["step_device_ms_ungated"])
    print(f"  step kernel {path}, one main-path run, device ms (profiler; "
          f"on, off, off, on): gated {rec['step_device_ms_gated']}, ungated "
          f"{rec['step_device_ms_ungated']}, gated/ungated "
          f"{gated / ungated:.3f}; bound of the tiles computed "
          f"{rec['step_bound_ms_gated']:.3f} (all launched "
          f"{rec['step_bound_ms_ungated']:.3f}); active-tile share "
          f"{rec['active_share_first_full']:.4f} with first passes full "
          f"({rec['active_share']:.4f} as run; the seed saved "
          f"{l1 - c1} of {l1} first-pass tiles), of {l0} tiles launched; "
          "per kernel " + ", ".join(
              f"{n} {b['share_first_full']:.4f} of {b['launched']} "
              f"({b['steps_per_tile']:.2f} steps each)"
              for n, b in by.items()) + "; same labels, the recorded "
          f"launches ({card})", flush=True)
    return rec


def _pad_planes(h, w, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints():
        return torch.randint(-(1 << 31), (1 << 31) - 1, (h, w), generator=g,
                             dtype=torch.int32, device=dev)
    return [ints(), torch.rand((h, w), generator=g, device=dev), ints(),
            ints()]


def _pad_checks(dev, card):
    """pad and unpad against their plain versions at PAD_SHAPES with 1 to 4
    fields and each t of PAD_FILLS, the route of each shape's 4-field calls
    read
    from the profiler; then the 8K planes (4 fields padded, 3 unpadded, as
    the compmin fixpoint does) timed like the main-path fields. Returns
    (name -> max abs error, name -> 8K record)."""
    errs = {n: 0.0 for n in PADS}
    for (h, w), route in PAD_SHAPES.items():
        planes = _pad_planes(h, w, dev, seed=h + w)
        hp, wp = -(-h // 32) * 32, -(-w // 128) * 128
        for t, fills in PAD_FILLS.items():
            for k in range(1, 5):
                pad = (list(zip(planes[:k], fills[:k])), t, hp, wp)
                unpad = (kp.fast_pad_fields(*pad), t, h, w)
                for name, args in (("pad_fields", pad),
                                   ("unpad_fields", unpad)):
                    errs[name] = max(errs[name], _compare(name, args))
                    taken = set(_routes_ms(_kernel_fn(name, args), name)) \
                        if k == 4 else {route}
                    if taken != {route}:
                        raise AssertionError(
                            f"{name} {h}x{w}: ran routes {sorted(taken)} "
                            f"where {route} alone was due")
        print(f"check pad/unpad {h}x{w} (hp {hp}, wp {wp}), 1-4 fields, t "
              f"{sorted(PAD_FILLS)}, fills {PAD_FILLS}: equal to plain, "
              f"{route} route", flush=True)
    h, w = PAD_8K
    planes = _pad_planes(h, w, dev, seed=8)
    pad = (list(zip(planes, PAD_FILLS[8])), 8, h, w)
    unpad = (kp.fast_pad_fields(*pad)[1:], 8, h, w)
    timed = _time_kernels({"pad_fields": (pad, {}),
                           "unpad_fields": (unpad, {})},
                          f"{h}x{w} planes", card, plain_reps=3)
    for name, rec in timed.items():
        errs[name] = max(errs[name], rec["max_abs_err"])
    return errs, timed


def _build_all():
    """One nvcc per source, all started together."""
    _build.load_all(verbose=True)
    for s, secs in sorted(_build.build_seconds.items()):
        print(f"build {s}.cu: {secs:.2f} s", flush=True)


def _random_checks(dev):
    """Every kernel against its plain version on random fields; the
    closure-route fixpoints from their first pass; run extraction at the
    identity labeling (every pixel a run: the pool overflows). Returns
    name -> max abs error."""
    errs = {name: 0.0 for name in KERNELS}
    warm = kg.WARM_PASSES
    for h, w in RANDOM_SHAPES:
        args = _random_args(h, w, dev, seed=h * 7 + w)
        for name, a in args.items():
            errs[name] = max(errs[name], _compare(name, a))
            print(f"check {name} {h}x{w}: equal to plain", flush=True)
        for name in STEP:
            n, err = _gated_passes(name, args[name])
            errs[name] = max(errs[name], err)
            print(f"check {name} {h}x{w} gated passes: {n} passes equal to "
                  "step_pass_plain", flush=True)
        kg.WARM_PASSES = 0
        try:
            for name in CLOSURE_OF.values():
                errs[name] = max(errs[name], _compare(name, args[name],
                                                      {"closures": True}))
                print(f"check {name} closures=True WARM_PASSES=0 {h}x{w}: "
                      "equal to plain", flush=True)
        finally:
            kg.WARM_PASSES = warm
        vid = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w)
        errs["run_extract"] = max(errs["run_extract"],
                                  _compare("run_extract", (vid, h * w // 2)))
        print(f"check run_extract identity labeling {h}x{w} (overflow): "
              "equal to plain", flush=True)
    return errs


RUN_WIDTHS = (1, 31, 32, 33, 1920, 3840)


def _runs_pairs(res):
    """The filled slots of a run pool as a Counter of (label, length)."""
    lab, cnt = res[0].cpu(), res[1].cpu()
    live = lab != kr.INT32_MAX
    return collections.Counter(zip(lab[live].tolist(), cnt[live].tolist()))


def _runs_checks(dev):
    """run_extract against its plain version on 9-row planes of each width
    in RUN_WIDTHS, every row one run (all equal) or runs of one pixel
    (alternating labels), at caps 0, 1, count - 1 and count: equal sorted
    multisets and exact counts; at overflow, the filled slots a
    sub-multiset of the plane's pairs. Returns the max abs error."""
    err, h = 0.0, 9
    for w in RUN_WIDTHS:
        planes = {
            "all-equal": torch.arange(h, dtype=torch.int32, device=dev)[
                :, None].expand(h, w).contiguous(),
            "alternating": (torch.arange(h * w, device=dev).reshape(h, w)
                            % 2).int()}
        for kind, L in planes.items():
            full = kr.run_extract_plain(L, h * w)
            count = int(full[2])
            caps = sorted({0, 1, max(count - 1, 0), count})
            for cap in caps:
                err = max(err, _compare("run_extract", (L, cap)))
                if count > cap:
                    got = _runs_pairs(kr.run_extract(L, cap))
                    if sum(got.values()) != cap or got - _runs_pairs(full):
                        raise AssertionError(
                            f"run_extract {kind} {h}x{w} cap {cap}: the "
                            "filled slots are not pairs of the plane")
            print(f"check run_extract {kind} rows {h}x{w}: equal to plain "
                  f"at caps {caps} ({count} pairs)", flush=True)
    return err


def _record_calls(image, cfg, name, outputs=False):
    """Every call of one kernel wrapper in one main-path run: its arguments,
    or (outputs=True) the first field of its result."""
    k = KERNELS[name]
    fn = getattr(k.mod, k.attr)
    got = []

    def rec(*args, **kwargs):
        out = fn(*args, **kwargs)
        got.append(_clone(out[0] if outputs else args))
        return out

    setattr(k.mod, k.attr, rec)
    try:
        turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS)
    finally:
        setattr(k.mod, k.attr, fn)
    return got


def _canonical(labels):
    """Canonical min-pixel-id labels of an (H, W) map whose labels lie in
    [0, H*W) (root ids or canonical ids), on the device: the same array as
    utils.labels.canonical_min_labels_np."""
    flat = labels.reshape(-1).long()
    v = flat.numel()
    vid = torch.arange(v, dtype=torch.int32, device=labels.device)
    m = torch.full((v,), kr.INT32_MAX, dtype=torch.int32,
                   device=labels.device).scatter_reduce_(0, flat, vid, "amin")
    return m[flat].reshape(labels.shape)


def _level_stats(canon):
    """(components, sha256 of the int32 C-order bytes) of a canonical map."""
    vid = torch.arange(canon.numel(), dtype=torch.int32,
                       device=canon.device)
    n = int((canon.reshape(-1) == vid).sum())
    return n, hashlib.sha256(canon.cpu().numpy().tobytes()).hexdigest()


def _nested(fine, coarse):
    """Whether every class of the canonical map `fine` lies inside one
    class of `coarse`."""
    f = fine.reshape(-1).long()
    c = coarse.reshape(-1)
    lo = torch.full_like(c, kr.INT32_MAX).scatter_reduce_(0, f, c, "amin")
    return torch.equal(lo[f], c)


def _oracle_diff(labels, path):
    got = _canonical(labels)
    oracle = torch.from_numpy(load_oracle(path)).to(labels.device)
    return int((got != oracle).sum())


def _atomic_path(path, image, card):
    """The counted run of the atomic path (segment_atomic) or of its
    hierarchy: no kernel may launch; final labels 0 pixels off the 1080p
    oracle; its rounds by mode (each reads `merged` on the host once, and
    nothing else does), median ms of CUDA-event reps, peak memory. Returns
    the record and, for the hierarchy, its canonical levels."""
    cfg = dataclasses.replace(CFG, algorithm="atomic")
    hierarchy = path == "1080p_atomic_hierarchy"

    def run():
        if hierarchy:
            return atomic_boruvka.segment_atomic_hierarchy(image, cfg)
        return None, atomic_boruvka.segment_atomic(image, cfg)

    rounds = collections.Counter()
    one_round = atomic_boruvka._round

    def counted(*args):
        rounds[args[-1]] += 1  # the mode, "felz" or "minsize"
        return one_round(*args)

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    atomic_boruvka._round = counted
    try:
        levels, labels = run()
    finally:
        atomic_boruvka._round = one_round
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    _check_path_launches(path, launches)
    ndiff = _oracle_diff(labels, _WB0)
    reps = 5 if not hierarchy else 3
    ms = _cuda_ms(run, reps)
    felz, minsize = rounds["felz"], rounds["minsize"]
    rec = {"launches": launches, "peak_mib": peak, "main_ms": ms,
           "rounds_felz_minsize": [felz, minsize],
           "host_reads": felz + minsize, "oracle_pixels_differ": ndiff}
    print(f"main path {path}: launches none of the {len(KERNELS)} kernels; "
          f"rounds felz {felz}, min-size {minsize}, host reads "
          f"{felz + minsize}; oracle partition ({_WB0.relative_to(ROOT)}): "
          f"{ndiff} pixels differ; median {ms:.3f} ms of {reps} reps = "
          f"{image.shape[0] * image.shape[1] / 1e3 / ms:.2f} MPix/s; peak "
          f"memory {peak:.1f} MiB ({card})", flush=True)
    if ndiff:
        raise AssertionError(f"{path}: partition differs from the oracle")
    canon = [_canonical(lv) for lv in levels] if hierarchy else None
    return rec, canon


def _turbo_hierarchy_path(image, card):
    """The counted run of the turbo hierarchy: flags 0, the recorded
    launches, level 0 the identity, levels nested, final labels 0 pixels
    off the oracle and equal to segment_turbo_flagged's; median ms of
    CUDA-event reps, peak memory. Returns the record and its canonical
    levels."""
    path = TURBO_HIERARCHY
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with _traced() as traced:
        levels, labels, flags = turbo.segment_turbo_hierarchy_flagged(
            image, CFG, GOSSIP_ROUNDS)
        torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    hybrid = _hybrid(traced.rec)
    print(f"main path {path}: flags {flags} ({turbo.describe_flags(flags)}),"
          f" launches {launches}, {len(hybrid)} hybrid fixpoints "
          f"(variant, step passes, pairs) {hybrid}; peak memory "
          f"{peak:.1f} MiB", flush=True)
    if flags != 0:
        raise AssertionError(f"{path}: raised flags {flags}")
    _check_path_launches(path, launches)
    canon = [_canonical(lv) for lv in levels]
    vid = torch.arange(labels.numel(), dtype=torch.int32,
                       device=labels.device).reshape(labels.shape)
    if not torch.equal(levels[0], vid):
        raise AssertionError(f"{path}: level 0 is not the identity")
    loose = [i for i in range(len(canon) - 1)
             if not _nested(canon[i], canon[i + 1])]
    if loose:
        raise AssertionError(f"{path}: levels {loose} do not nest in the "
                             "next")
    ndiff = _oracle_diff(labels, _WB0)
    ref, rflags = turbo.segment_turbo_flagged(image, CFG, GOSSIP_ROUNDS)
    same = rflags == 0 and torch.equal(ref, labels)
    ms = _cuda_ms(lambda: turbo.segment_turbo_hierarchy_flagged(
        image, CFG, GOSSIP_ROUNDS), 3)
    print(f"  {path}: level 0 the identity, {len(canon)} levels nested; "
          f"final labels: oracle partition {ndiff} pixels differ, equal to "
          f"segment_turbo_flagged's: {same}; median {ms:.3f} ms of 3 reps "
          f"({card})", flush=True)
    if ndiff or not same:
        raise AssertionError(f"{path}: final labels differ")
    return {"launches": launches, "peak_mib": peak, "main_ms": ms,
            "hybrid_variant_steps_pairs": hybrid}, canon


def _check_levels(atomic_canon, turbo_canon):
    """Each level of both hierarchies against the committed reference level
    (component count and sha256 of the canonical map) and the two
    hierarchies against each other, pixel for pixel; prints each mismatch
    (component counts, pixels apart) and raises after all are printed.
    Returns the per-level component counts."""
    ref = load_level_oracle(LEVEL_ORACLE)["levels"]
    if not len(ref) == len(atomic_canon) == len(turbo_canon):
        raise AssertionError(f"level counts {len(ref)}, {len(atomic_canon)}"
                             f", {len(turbo_canon)}")
    bad, counts = [], []
    for i, (r, a, t) in enumerate(zip(ref, atomic_canon, turbo_canon)):
        (na, ha), (nt, ht) = _level_stats(a), _level_stats(t)
        apart = int((a != t).sum())
        counts.append(nt)
        if ha != r["sha256"] or ht != r["sha256"] or apart:
            bad.append(i)
            print(f"  level {i} differs: components reference "
                  f"{r['components']}, atomic {na}, turbo {nt}; sha256 "
                  f"equal to the reference's: atomic {ha == r['sha256']}, "
                  f"turbo {ht == r['sha256']}; atomic and turbo {apart} "
                  "pixels apart", flush=True)
    print(f"check levels: {len(ref)} levels of {TURBO_HIERARCHY} and "
          f"1080p_atomic_hierarchy, {len(ref) - len(bad)} equal to the "
          f"committed reference levels "
          f"(gseg_tpu_torch/oracles/{LEVEL_ORACLE}.json) and to each other;"
          f" components per level {counts}", flush=True)
    if bad:
        raise AssertionError(f"hierarchy levels {bad} differ")
    return counts


def _new_paths(images, card):
    """The atomic path, its hierarchy and the turbo hierarchy at 1080p,
    each with the launch counts set to 0 just before it and read just
    after. Returns name -> record."""
    P = PATHS["1080p_subsum"]
    image = images[P.h, P.w]
    out = {}
    out["1080p_atomic"], _ = _atomic_path("1080p_atomic", image, card)
    out["1080p_atomic_hierarchy"], a_canon = _atomic_path(
        "1080p_atomic_hierarchy", image, card)
    out[TURBO_HIERARCHY], t_canon = _turbo_hierarchy_path(image, card)
    counts = _check_levels(a_canon, t_canon)
    for p in ("1080p_atomic_hierarchy", TURBO_HIERARCHY):
        out[p]["level_components"] = counts
    return out


@contextlib.contextmanager
def _host_reads():
    """Counts the reads of CUDA tensors into host values (item, bool, int,
    float, tolist) while open: the host syncs of a path."""
    count = [0]
    names = ("item", "__bool__", "__int__", "__float__", "tolist")
    orig = {n: getattr(torch.Tensor, n) for n in names}

    def counted(fn):
        def read(self, *args, **kwargs):
            if self.is_cuda:
                count[0] += 1
            return fn(self, *args, **kwargs)
        return read

    for n, fn in orig.items():
        setattr(torch.Tensor, n, counted(fn))
    try:
        yield count
    finally:
        for n, fn in orig.items():
            setattr(torch.Tensor, n, fn)


def _dpp_split(path, image, cfg, reps=3):
    """Median ms of the DPP stages, run in sequence as the path runs them:
    round 1, extraction, compact rounds, final map (fastmst) or render of
    the level (superpixel, level 4)."""
    h, w = image.shape[:2]
    v = h * w
    if path in FASTMST:
        gst, weights = fastmst._round1_dense(image, cfg)
        st, rm, r0 = fastmst._extract_compact(gst, weights, v)
        st2 = fastmst._compact_rounds(st, v, cfg)
        return {
            "round1": _cuda_ms(lambda: fastmst._round1_dense(image, cfg),
                               reps),
            "extract": _cuda_ms(
                lambda: fastmst._extract_compact(gst, weights, v), reps),
            "compact_rounds": _cuda_ms(
                lambda: fastmst._compact_rounds(st, v, cfg), reps),
            "final_map": _cuda_ms(lambda: turbo._final_map(
                gst, st2, rm, r0, 4 * (h + w), closures=True), reps)}
    L1, size1, csum1, strength, merged1 = superpixel._round1_dense(image,
                                                                   cfg)
    x = superpixel._extract_compact(L1, strength, v)
    st = superpixel.SPCompact(esrc=x[0], edst=x[1], estr=x[2], eeid=x[3],
                              SZf=size1, CSf=csum1, fin=x[4], merged=merged1,
                              it=0, flags=x[7])
    st2, _ = superpixel._rounds(st, v, 3)
    return {
        "round1": _cuda_ms(lambda: superpixel._round1_dense(image, cfg),
                           reps),
        "extract": _cuda_ms(
            lambda: superpixel._extract_compact(L1, strength, v), reps),
        "compact_rounds_3": _cuda_ms(lambda: superpixel._rounds(st, v, 3),
                                     reps),
        "render": _cuda_ms(
            lambda: superpixel._render(L1, st2.fin, x[5], x[6]), reps)}


def _dpp_check_levels(path, canon, ref):
    """Each plane's component count and canonical sha256 against the level
    oracle's; prints each mismatch and raises after all are printed.
    Returns the components per plane."""
    if len(ref) != len(canon):
        raise AssertionError(f"{path}: {len(canon)} planes, the level "
                             f"oracle {len(ref)}")
    bad, counts = [], []
    for i, (r, c) in enumerate(zip(ref, canon)):
        n, sha = _level_stats(c)
        counts.append(n)
        if sha != r["sha256"]:
            bad.append(i)
            print(f"  {path} plane {i} differs: {n} components, the "
                  f"oracle {r['components']}", flush=True)
    print(f"check levels {path}: {len(ref) - len(bad)} of {len(ref)} planes "
          f"equal to the level oracle (gseg_tpu_torch/oracles/"
          f"{DPP_ORACLE}.json); components {counts}", flush=True)
    if bad:
        raise AssertionError(f"{path}: planes {bad} differ")
    return counts


def _dpp_path(path, image, card, run):
    """The counted run of one DPP path (launch counts 0 just before, read
    just after; host reads; peak memory), its launch checks, then its
    median ms of 5 CUDA-event reps after a warm-up, the value flood's
    device ms in one run (profiler) and its stage split. Returns (out,
    record)."""
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with _traced() as traced, _host_reads() as reads:
        out = run()
        torch.cuda.synchronize()
    launches = _counts()
    hybrid = _hybrid(traced.rec)
    peak = torch.cuda.max_memory_allocated() / 2**20
    flags = out[-1]
    print(f"main path {path}: flags {flags} ({turbo.describe_flags(flags)}),"
          f" launches {launches}, host reads {reads[0]}, {len(hybrid)} "
          f"hybrid fixpoints (variant, step passes, pairs) {hybrid}, peak "
          f"memory {peak:.1f} MiB", flush=True)
    if flags != 0:
        raise AssertionError(f"{path}: raised flags {flags}")
    _check_path_launches(path, launches)
    reps = 5
    ms = _cuda_ms(run, reps)
    value_ms = _device_ms(run, "gossip_value", 1)
    cfg = dataclasses.replace(CFG, algorithm="superpixel"
                              if path in SUPERPIXEL else "fastmst")
    split = _dpp_split(path, image, cfg)
    what, ti = GTX1080TI_MS[path]
    print(f"  {path}: median {ms:.3f} ms of {reps} reps = "
          f"{image.shape[0] * image.shape[1] / 1e3 / ms:.2f} MPix/s; value "
          f"flood on the device {value_ms:.4f} ms in "
          f"{launches['gossip_value']} launches; stage split (median ms of "
          "3): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" ({card}); GTX 1080 Ti {what}: {ti} ms", flush=True)
    return out, {"launches": launches, "peak_mib": peak, "main_ms": ms,
                 "host_reads": reads[0], "value_device_ms": value_ms,
                 "stages_ms": split, "hybrid_variant_steps_pairs": hybrid,
                 "gtx1080ti_ms": ti}


def _dpp_paths(images, card):
    """Step 7: fastmst at 1080p and 4K, its hierarchy, superpixel level 4
    and the superpixel hierarchy at 1080p. Returns (path -> record, path
    -> timing records: the colour-sum helper's at the superpixel path's
    round-1 call, the stage-2 round's at the 4K fastmst frame's first
    round)."""
    image = images[1080, 1920]
    oracle = load_level_oracle(DPP_ORACLE)
    cfg = dataclasses.replace(CFG, algorithm="fastmst")
    out = {}

    (labels, _), out["1080p_fastmst"] = _dpp_path(
        "1080p_fastmst", image, card,
        lambda: fastmst.segment_fastmst_flagged(image, cfg))
    atomic = atomic_boruvka.segment_atomic(
        image, dataclasses.replace(CFG, algorithm="atomic"))
    raw = hashlib.sha256(labels.cpu().numpy().tobytes()).hexdigest()
    ndiff = _oracle_diff(labels, _WB0)
    same = torch.equal(labels, atomic)
    print(f"  1080p_fastmst: oracle partition ({_WB0.relative_to(ROOT)}): "
          f"{ndiff} pixels differ; root ids byte-equal to segment_atomic's:"
          f" {same}; raw sha256 equal to the level oracle's: "
          f"{raw == oracle['fastmst']['final_raw_sha256']}", flush=True)
    if ndiff or not same or raw != oracle["fastmst"]["final_raw_sha256"]:
        raise AssertionError("1080p_fastmst: labels differ")

    image4k = images[2160, 3840]
    (labels4k, _), out["4k_fastmst"] = _dpp_path(
        "4k_fastmst", image4k, card,
        lambda: fastmst.segment_fastmst_flagged(image4k, cfg))
    oracle4k = PATHS["4k_subsum"].oracle
    ndiff = _oracle_diff(labels4k, oracle4k)
    print(f"  4k_fastmst: oracle partition ({oracle4k.relative_to(ROOT)}): "
          f"{ndiff} pixels differ", flush=True)
    if ndiff:
        raise AssertionError("4k_fastmst: partition differs from the oracle")
    # the hand-written round at each of the 4K frame's rounds: V-indexed,
    # sink labels, pools of up to 2.5 V entries
    rounds = _wrapper_calls([S2], lambda: fastmst.segment_fastmst_flagged(
        image4k, cfg))[S2]
    if not rounds or any(kw["canonical"] for _, kw in rounds):
        raise AssertionError(f"4k_fastmst: {len(rounds)} rounds, canonical "
                             f"{[kw['canonical'] for _, kw in rounds]}")
    err = max(_compare(S2, a, kw) for a, kw in rounds)
    print(f"check {S2} 4k_fastmst main-path states: {len(rounds)} rounds "
          f"(pools of {[a[0].numel() for a, _ in rounds]} entries) equal "
          "to plain", flush=True)
    timed4k = _time_kernels({S2: rounds[0]}, "4k_fastmst round-1 state",
                            card, 1)
    timed4k[S2]["max_abs_err"] = max(err, timed4k[S2]["max_abs_err"])
    del rounds
    # the join at the 4K frame's boundary pairs (33,177,600 slots, 254
    # chunks, pair cap 10,368,000), also forced to overflow; timed there
    joins, jerr = _join_checks(
        "4k_fastmst", lambda: fastmst.segment_fastmst_flagged(image4k, cfg),
        overflow=True)
    timed4k |= _time_kernels({PJ: (joins[0], {})},
                             "4k_fastmst boundary pairs", card, 3)
    del joins

    (levels, hlabels, _), out["1080p_fastmst_hierarchy"] = _dpp_path(
        "1080p_fastmst_hierarchy", image, card,
        lambda: fastmst.segment_fastmst_hierarchy_flagged(image, cfg))
    canon = [_canonical(lv) for lv in levels]
    vid = torch.arange(labels.numel(), dtype=torch.int32,
                       device=labels.device).reshape(labels.shape)
    loose = [i for i in range(len(canon) - 1)
             if not _nested(canon[i], canon[i + 1])]
    if not torch.equal(levels[0], vid) or loose:
        raise AssertionError(f"1080p_fastmst_hierarchy: level 0 the "
                             f"identity: {torch.equal(levels[0], vid)}; "
                             f"levels {loose} do not nest in the next")
    if not torch.equal(hlabels, labels):
        raise AssertionError("1080p_fastmst_hierarchy: final labels differ "
                             "from 1080p_fastmst's")
    out["1080p_fastmst_hierarchy"]["level_components"] = _dpp_check_levels(
        "1080p_fastmst_hierarchy", canon, oracle["fastmst"]["levels"])
    jerr = max(jerr, _join_checks(
        "1080p_fastmst_hierarchy",
        lambda: fastmst.segment_fastmst_hierarchy_flagged(image, cfg))[1])

    scfg = dataclasses.replace(CFG, algorithm="superpixel")
    (lvl4, _), out["1080p_superpixel"] = _dpp_path(
        "1080p_superpixel", image, card,
        lambda: superpixel.segment_superpixel_flagged(image, scfg))
    n, sha = _level_stats(_canonical(lvl4))
    ref4 = oracle["superpixel"]["levels"][4]
    print(f"  1080p_superpixel: level 4, {n} components, canonical sha256 "
          f"equal to the level oracle's plane 4 ({ref4['components']} "
          f"components): {sha == ref4['sha256']}", flush=True)
    if sha != ref4["sha256"]:
        raise AssertionError("1080p_superpixel: level 4 differs")

    def sp_hierarchy():
        return superpixel.segment_superpixel_hierarchy_flagged(image, scfg)

    (slevels, _, _), out["1080p_superpixel_hierarchy"] = _dpp_path(
        "1080p_superpixel_hierarchy", image, card, sp_hierarchy)
    counts = _dpp_check_levels("1080p_superpixel_hierarchy",
                               [_canonical(lv) for lv in slevels],
                               oracle["superpixel"]["levels"])
    again = sp_hierarchy()[0]
    print(f"  1080p_superpixel_hierarchy: components collapse to "
          f"{counts[-1]}; two runs bit-equal: {torch.equal(again, slevels)}"
          f"; level 4 equal to segment_superpixel's: "
          f"{torch.equal(slevels[4], lvl4)}", flush=True)
    if counts[-1] != 1 or not torch.equal(again, slevels) \
            or not torch.equal(slevels[4], lvl4):
        raise AssertionError("1080p_superpixel_hierarchy: runs differ")
    out["1080p_superpixel_hierarchy"]["level_components"] = counts
    jerr = max(jerr, _join_checks("1080p_superpixel_hierarchy",
                                  sp_hierarchy)[1])
    timed4k[PJ]["max_abs_err"] = max(jerr, timed4k[PJ]["max_abs_err"])

    args = _wrapper_calls(["ordered_scatter_add"], sp_hierarchy,
                          first_only=True)["ordered_scatter_add"][0][0]
    timed = _time_kernels({"ordered_scatter_add": (args, {})},
                          "1080p_superpixel round-1 colour sums", card, 3)
    return out, {"1080p_superpixel": timed, "4k_fastmst": timed4k}


def _cli(argv):
    """`gseg_tpu_torch.cli.main(argv)` in this process: (its --time record,
    wall seconds). The CLI's JSON line is printed as it comes."""
    from gseg_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main{argv} returned {rc}")
    line = out.getvalue().strip().splitlines()[-1]
    print(f"  cli: {line}", flush=True)
    return json.loads(line), wall


def _check_render(render, labels, what, distinct):
    """Every component of `labels` painted in one colour; with `distinct`,
    as many colours as components (random colours of many components may
    coincide: 8,154 of 226^3 share ~3 by chance)."""
    code = (render[..., 0].astype(np.int64) << 16
            | render[..., 1].astype(np.int64) << 8 | render[..., 2])
    n = np.unique(labels).size
    pairs = np.unique(labels.astype(np.int64) << 24 | code).size
    colours = np.unique(code).size
    print(f"  {what}: {n} components, {pairs} (component, colour) pairs, "
          f"{colours} colours", flush=True)
    if pairs != n or (distinct and colours != n):
        raise AssertionError(f"{what}: the rendering does not paint one "
                             "colour per component")


def _cli_paths(image, card):
    """Step 8: the CLI at 1080p on the card, each run with the launch counts
    set to 0 just before it and read just after. Returns name -> record."""
    from gseg_tpu_torch.utils import image_io

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = FsPath(tmp)
        src = str(tmp / "in.ppm")
        image_io.write_ppm(src, image.cpu().numpy())

        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        rec, wall = _cli([src, str(tmp / "out.ppm"), "--algorithm", "turbo",
                          "--labels-out", str(tmp / "l.npy"), "--time"])
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        _check_path_launches(CLI, launches)
        labels = np.load(tmp / "l.npy")
        oracle = load_oracle(_WB0)
        ndiff = int((canonical_min_labels_np(labels) != oracle).sum())
        print(f"main path {CLI}: launches {launches} (equal to "
              f"1080p_subsum's, run {RECORDED_LAUNCHES[CLI][0]}); oracle "
              f"partition ({_WB0.relative_to(ROOT)}): {ndiff} pixels "
              f"differ; segment_s {rec['segment_s']}, whole run "
              f"{wall:.3f} s; peak memory {peak:.1f} MiB ({card})",
              flush=True)
        if ndiff:
            raise AssertionError(f"{CLI}: partition differs from the oracle")
        _check_render(image_io.read_image(str(tmp / "out.ppm")), labels,
                      f"{CLI} out.ppm", distinct=True)
        out[CLI] = {"launches": launches, "segment_s": rec["segment_s"],
                    "whole_run_s": wall, "peak_mib": peak,
                    "oracle_pixels_differ": ndiff}

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gseg_tpu_torch", src,
             str(tmp / "sub.ppm"), "--algorithm", "turbo", "--labels-out",
             str(tmp / "sub.npy"), "--time"], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        sub_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError("python -m gseg_tpu_torch exited "
                                 f"{proc.returncode}:\n{proc.stderr}")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        same = np.array_equal(np.load(tmp / "sub.npy"), labels)
        print(f"  {CLI} as `python -m gseg_tpu_torch`: {proc.stdout.strip()}"
              f"; process {sub_wall:.3f} s; labels equal to the in-process "
              f"run's: {same}", flush=True)
        if not same:
            raise AssertionError(f"{CLI}: the subprocess's labels differ")
        out[CLI] |= {"subprocess_s": sub_wall,
                     "subprocess_segment_s": sub["segment_s"]}

        _reset_counts()
        rec, wall = _cli([src, str(tmp / "l4.ppm"), "--algorithm", "turbo",
                          "--hierarchy-level", "4", "--labels-out",
                          str(tmp / "l4.npy"), "--time"])
        launches = _counts()
        _check_path_launches(CLI_LEVEL4, launches)
        l4 = np.load(tmp / "l4.npy")
        n, sha = _level_stats(torch.from_numpy(canonical_min_labels_np(l4)))
        ref = load_level_oracle(LEVEL_ORACLE)["levels"][4]
        print(f"main path {CLI_LEVEL4}: launches {launches} (equal to "
              f"{TURBO_HIERARCHY}'s, run {RECORDED_LAUNCHES[CLI_LEVEL4][0]});"
              f" level 4: {n} components, canonical sha256 equal to the "
              f"level oracle's ({ref['components']} components): "
              f"{sha == ref['sha256']}; segment_s {rec['segment_s']}, whole "
              f"run {wall:.3f} s ({card})", flush=True)
        if sha != ref["sha256"]:
            raise AssertionError(f"{CLI_LEVEL4}: level 4 differs")
        _check_render(image_io.read_image(str(tmp / "l4.ppm")), l4,
                      f"{CLI_LEVEL4} l4.ppm", distinct=False)
        out[CLI_LEVEL4] = {"launches": launches,
                           "segment_s": rec["segment_s"],
                           "whole_run_s": wall, "level4_components": n}

        _reset_counts()
        rec, wall = _cli([src, str(tmp / "kn.ppm"), "--algorithm",
                          "kruskal_native", "--labels-out",
                          str(tmp / "kn.npy"), "--time"])
        launches = _counts()
        _check_path_launches(CLI_NATIVE, launches)
        sizes = np.bincount(np.load(tmp / "kn.npy").ravel())
        host = _build.host_cpu()
        print(f"main path {CLI_NATIVE}: launches none; {sizes.size} "
              f"components, the smallest {sizes.min()} px (min_size 100); "
              f"segment_s {rec['segment_s']} on the host ({host}; C++ "
              "felz.cpp built with g++ -O3 -march=native), whole run "
              f"{wall:.3f} s; the reference's CPU baseline on its own "
              f"machine: {REFERENCE_CPU_1080P_S} s total (BASELINE.md:49)",
              flush=True)
        if sizes.min() < CFG.min_size:
            raise AssertionError(f"{CLI_NATIVE}: a component below "
                                 "min_size")
        out[CLI_NATIVE] = {"launches": launches,
                           "segment_s": rec["segment_s"],
                           "whole_run_s": wall, "host_cpu": host,
                           "components": int(sizes.size)}
    return out


def _bsds_field_checks(image, errs):
    """Every kernel of the turbo path against its plain version (and the
    step kernels pass by pass against step_pass_plain) at the fields that
    `segment_turbo_flagged` gives them on image 0 of step 9, in speed and
    quality mode at K=80."""
    for extra in ({}, {"weight_buckets": 16}):
        cfg = SegmentationConfig(k=80.0, min_size=100, algorithm="turbo",
                                 **extra)
        label = f"bsds_like 321x481 wb{cfg.weight_buckets}"
        fields = _capture_main_path_fields(image, cfg)
        for name in [n for n in STEP if n in fields]:
            n, err = _gated_passes(name, *fields[name])
            errs[name] = max(errs[name], err)
            print(f"check {name} {label} main-path fields gated passes: {n} "
                  "passes equal to step_pass_plain", flush=True)
        for name, (args, kwargs) in fields.items():
            errs[name] = max(errs[name], _compare(name, args, kwargs))
            print(f"check {name} {label} main-path fields {sorted(kwargs)}:"
                  " equal to plain", flush=True)


def _bsds_dpp_field_checks(image, errs):
    """The value-flood kernel, and on superpixel the colour-sum helper,
    against its plain version at every call that the fastmst and
    superpixel rows of step 9 make on image 0 (`segment_level_fn` at the
    protocol's configuration)."""
    from gseg_tpu_torch.bench import harness

    h, w = image.shape[:2]
    for algo, names in (("fastmst", ["gossip_value"]),
                        ("superpixel", ["gossip_value",
                                        "ordered_scatter_add"])):
        cfg = SegmentationConfig(k=80.0, min_size=100,
                                 on_overflow="fallback")
        fn = harness.segment_level_fn(algo, cfg, level=4,
                                      device=image.device)
        calls = _wrapper_calls(names, lambda: fn(image))
        for name in names:
            for args, kwargs in calls[name]:
                errs[name] = max(errs[name], _compare(name, args, kwargs))
            print(f"check {name} bsds_like {h}x{w} {algo} level 4 main-path"
                  f" fields: all {len(calls[name])} calls equal to plain",
                  flush=True)
            if not calls[name]:
                raise AssertionError(f"{name}: no call on the {algo} row")


def _score_on_device(labels, dev_gts):
    """ASA/UE of `labels` against the ASA-maximizing ground truth (the
    first on a tie), each with asa_ue_torch on the labels' device."""
    uniq, seg = torch.unique(labels, return_inverse=True)
    best = (-1.0, 0.0)
    for gt, ngt in dev_gts:
        asa, ue = asa_ue_torch(seg, gt, uniq.numel(), ngt)
        if float(asa) > best[0]:
            best = (float(asa), float(ue))
    return best


def _bsds_quality(dev, card, errs):
    """Step 9: the reference's quality protocol on the card, each algorithm
    with the launch counts set to 0 just before its 20 images and read just
    after. Every row is scored with asa_ue_best_gt on the host and with
    asa_ue_torch on the card, and must equal the committed record's row.
    Returns name -> record."""
    from gseg_tpu_torch.bench import harness
    from gseg_tpu_torch.utils.datasets import bsds_like_quality_set

    samples = list(bsds_like_quality_set(n=20))
    with open(QUALITY_RECORD) as f:
        record = {(r["image"], r["algorithm"]): r
                  for r in map(json.loads, f)}
    images = [torch.from_numpy(img).to(dev) for _, img, _ in samples]
    dev_gts = []
    for _, _, gts in samples:
        dev_gts.append([])
        for g in gts:
            u, inv = torch.unique(torch.from_numpy(g).to(dev),
                                  return_inverse=True)
            dev_gts[-1].append((inv, u.numel()))
    _bsds_field_checks(images[0], errs)
    _bsds_dpp_field_checks(images[0], errs)
    out, bad = {}, []
    for name, extra in QUALITY_ALGOS:
        path = BSDS[name]
        base = "turbo" if extra else name
        cfg = SegmentationConfig(k=80.0, min_size=100,
                                 on_overflow="fallback", **extra)
        fn = (harness.segment_fn(base, cfg) if extra
              else harness.segment_level_fn(base, cfg, level=4))
        _reset_counts()
        labels, ms = [], []
        with _traced() as traced, _host_reads() as reads:
            for image in images:
                t0 = time.perf_counter()
                labels.append(fn(image))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        launches, axis = _counts(), _axis_counts()
        hybrid = _hybrid(traced.rec)
        rows = []
        for (iname, _, gts), lab, dgts in zip(samples, labels, dev_gts):
            host = asa_ue_best_gt(compact_labels_np(lab.cpu().numpy()), gts)
            on_dev = _score_on_device(lab, dgts)
            ref = record[iname, name]
            rows.append(host)
            if on_dev != host or host != (ref["asa"], ref["ue"]):
                bad.append((name, iname))
                print(f"  {path} {iname}: host {host}, card {on_dev}, "
                      f"record {(ref['asa'], ref['ue'])}", flush=True)
        asa = statistics.median(r[0] for r in rows)
        ue = statistics.median(r[1] for r in rows)
        rec_rows = [record[iname, name] for iname, _, _ in samples]
        engaged = [h for h in hybrid if h[2] > 0]
        print(f"main path {path}: launches {launches}, host reads "
              f"{reads[0]}, {len(hybrid)} hybrid fixpoints, {len(engaged)} "
              f"of them reached the closures (closure launches rows, "
              f"columns {axis}); ASA median {asa:.4f} (record "
              f"{statistics.median(r['asa'] for r in rec_rows):.4f}), UE "
              f"median {ue:.4f} (record "
              f"{statistics.median(r['ue'] for r in rec_rows):.4f}); median "
              f"{statistics.median(ms):.3f} ms per image of {len(ms)} ({card}"
              + (f"; host {_build.host_cpu()}"
                 if name in ("kruskal_native", "boruvka_cpu") else "")
              + ")", flush=True)
        _check_path_launches(path, launches)
        out[path] = {"launches": launches, "host_reads": reads[0],
                     "median_ms_per_image": statistics.median(ms),
                     "asa_median": asa, "ue_median": ue,
                     "hybrid_fixpoints": len(hybrid),
                     "hybrid_reached_closures": len(engaged),
                     "closure_launches_rows_cols": axis}
    n = len(QUALITY_ALGOS) * len(samples)
    print(f"check bsds_like_quality: {n - len(bad)} of {n} rows equal to "
          f"{QUALITY_RECORD.relative_to(ROOT)} and to asa_ue_torch on the "
          "card", flush=True)
    if bad:
        raise AssertionError(f"bsds_like_quality: rows {bad} differ")
    return out


# ---------------------------------------------------------------------------
# step 10: batching and multi-device
# ---------------------------------------------------------------------------

_WB0_4K = ROOT / "bench_out/oracle_bench_2160x3840_wb0.npy"
# variant -> the kernels line's name of its step kernel row
STEP_OF = {v: n for n, v in STEP.items()}
_SLAB_STEP = kg._slab_step_kernel  # the unpatched slab pass


# the plain versions that the spatial fixpoints sweep with on the CPU
_SWEEPS = ("compmin_gossip_plain", "label_gossip_plain", "label_flood_plain",
           "value_flood_plain", "subtree_sums_plain")


@contextlib.contextmanager
def _no_sweeps(path):
    """Counts the calls of the step kernel's plain versions (the spatial
    fixpoints' CPU sweeps) while open; raises if one ran (on the card every
    spatial fixpoint must run the kernel)."""
    count = [0]
    orig = {name: getattr(kg, name) for name in _SWEEPS}

    def counted(fn):
        def call(*args):
            count[0] += 1
            return fn(*args)
        return call

    for name, fn in orig.items():
        setattr(kg, name, counted(fn))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(kg, name, fn)
    if count[0]:
        raise AssertionError(f"{path}: {count[0]} sweeps of the plain "
                             "version ran on the card")


def _peak_reset(dev=None):
    """Synchronise, zero the peak statistic of `dev` (default: the current
    card) and return the bytes allocated now."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak_since(base, dev=None):
    """MiB of the peak allocation of `dev` above `base` bytes."""
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**20


def _parallel_counted(path, run):
    """The counted run of a step-10 path: launch counts 0 just before and
    read just after, host reads (every thread's), peak device memory (all
    ranks of the card together, above what was allocated before the run),
    step-kernel passes. Returns (out, record)."""
    _reset_counts()
    base = _peak_reset()
    with _no_sweeps(path), _host_reads() as reads:
        out = run()
        torch.cuda.synchronize()
    launches = _counts()
    peak = _peak_since(base)
    passes = sum(launches[n] for n in STEP)
    print(f"main path {path}: launches {launches}, step-kernel passes "
          f"{passes}, host reads {reads[0]}, peak memory {peak:.1f} MiB",
          flush=True)
    _check_path_launches(path, launches)
    return out, {"launches": launches, "peak_mib": peak,
                 "step_passes": passes, "host_reads": reads[0]}


def _timed(path, run, rec, card, reps=3, what=""):
    """Median CUDA-event ms of `reps` runs after a warm-up, into rec."""
    rec["main_ms"] = ms = _cuda_ms(run, reps)
    print(f"  {path}: median {ms:.3f} ms of {reps} reps{what} ({card})",
          flush=True)


def _batch_path(path, images, oracle, card):
    """segment_batch of the images, turbo in speed mode: flags 0, image 0
    0 pixels off the oracle, every image bit-equal to a single
    segment_turbo_flagged call (at 1080p also segment_batch_sharded over
    two ranks of the card)."""
    batch = torch.stack(images)
    (labels, flags), rec = _parallel_counted(
        path, lambda: batching.segment_batch_flagged(batch, CFG))
    if flags:
        raise AssertionError(f"{path}: flags {flags}")
    rec["oracle_pixels_differ"] = ndiff = _oracle_diff(labels[0], oracle)
    singles = [turbo.segment_turbo_flagged(im, CFG, GOSSIP_ROUNDS)
               for im in images]
    same = [torch.equal(labels[i], lab) and f == 0
            for i, (lab, f) in enumerate(singles)]
    msg = (f"check {path}: image 0 {ndiff} pixels off "
           f"{oracle.relative_to(ROOT)}; images equal to single calls "
           f"{same}")
    if path == "1080p_batch4":
        blocks = batching.segment_batch_sharded(
            batch, CFG, batching.data_parallel_mesh(["cuda:0"] * 2))
        sharded = torch.equal(torch.cat(blocks), labels)
        msg += f"; segment_batch_sharded over 2 ranks equal: {sharded}"
        same.append(sharded)
    print(msg, flush=True)
    if ndiff or not all(same):
        raise AssertionError(f"{path}: labels differ")
    n = len(images)
    _timed(path, lambda: batching.segment_batch_flagged(batch, CFG), rec,
           card, what=f" for {n} images")
    rec["ms_per_image"] = rec["main_ms"] / n
    print(f"  {path}: {rec['ms_per_image']:.3f} ms per image = "
          f"{batch[0].numel() / 3 / 1e3 / rec['ms_per_image']:.2f} MPix/s "
          f"({card})", flush=True)
    return rec


class _SlabCapture:
    """Records, per (rank, variant), the slab pass number `nth` (1-based)
    of the spatial fixpoints while open (the pass's read-only slab and
    input fields), for ranks `ranks`."""

    def __init__(self, ranks, nth=2):
        self.ranks, self.nth = set(ranks), nth
        self.got, self._seen = {}, collections.Counter()
        self._lock = threading.Lock()

    def __enter__(self):
        def rec(variant, ro, src, dst):
            name = threading.current_thread().name
            rank = int(name.rsplit("-", 1)[1]) if name.startswith(
                "gseg-rank-") else -1
            with self._lock:
                self._seen[rank, variant] += 1
                n = self._seen[rank, variant]
            if rank in self.ranks and n <= self.nth:
                self.got[rank, variant] = (ro.clone(),
                                           [x.clone() for x in src])
            return _SLAB_STEP(variant, ro, src, dst)

        kg._slab_step_kernel = rec
        return self

    def __exit__(self, *exc):
        kg._slab_step_kernel = _SLAB_STEP


def _slab_checks(got, what, errs, slab):
    """Each captured slab pass by the kernel and by step_pass_plain from
    the same input: equal fields (max_abs_err 0)."""
    for (rank, variant), (ro, src) in sorted(got.items()):
        dk = [torch.empty_like(x) for x in src]
        dp = [torch.empty_like(x) for x in src]
        _SLAB_STEP(variant, ro, src, dk)
        kg.step_pass_plain(variant, ro, src, dp)
        name = STEP_OF[variant]
        errs[name] = max(errs[name], _max_abs_err(dk, dp))
        rec = slab.setdefault(name, {"checked": 0})
        rec["checked"] += 1
        if rank == 1 and f"ms_{what}" not in rec:
            rec[f"ms_{what}"] = _cuda_ms(
                lambda: _SLAB_STEP(variant, ro, src, dk), 5)
            rec[f"plain_ms_{what}"] = _cuda_ms(
                lambda: kg.step_pass_plain(variant, ro, src, dp), 1)
            rec[f"slab_{what}"] = list(ro.shape)
        print(f"check {name} {what} slab pass (rank {rank}, "
              f"{ro.shape[0]}x{ro.shape[1]}): equal to step_pass_plain",
              flush=True)


def _labelnd_slabs(tiles, ranks, what, errs, slab):
    """The label flood on the slab route at main-path inputs (the spatial
    path floods with the BFS dist, so its label+dist inputs, `tiles`, stand
    in): equal to the dense flood on the card, and its captured passes to
    step_pass_plain."""
    dev = tiles[0][0].device
    ms = 4 * (sum(t[0].shape[0] for t in tiles) + tiles[0][0].shape[1])
    with _SlabCapture(ranks) as cap:
        out = run_ranks(
            [dev] * len(tiles),
            lambda rank, t: kg.label_flood_spatial(*t, ms, rank), tiles)
    dense = kg.label_flood(*[torch.cat([t[f] for t in tiles])
                             for f in range(3)], ms)
    got = [torch.cat([o[f] for o in out]) for f in range(2)]
    errs["gossip_labelnd"] = max(errs["gossip_labelnd"],
                                 _max_abs_err(got, dense[:2]))
    if out[0][2] or dense[2]:
        raise AssertionError(f"{what}: label flood unconverged")
    print(f"check gossip_labelnd {what} slab route at the label+dist "
          "inputs: equal to the dense flood", flush=True)
    _slab_checks(cap.got, what, errs, slab)


# spatial turbo path -> the name of its slab checks in the kernels line
_SLAB_WHAT = {"1080p_spatial4": "1080p", "1080p_spatial4_wb16": "1080p_wb16",
              "4k_spatial4": "4k", "spatial8_short_tiles": "short_tiles"}


def _spatial_turbo_path(path, image, cfg, ranks, rounds, oracle, card, errs,
                        slab):
    """segment_turbo_spatial over `ranks` ranks of the card: flags 0, labels
    bit-equal to the dense segment_turbo_flagged (gossip_rounds 2) and 0
    pixels off the oracle; the slab passes of ranks at the top, middle and
    bottom against step_pass_plain (label flood: at the label+dist
    inputs); on the 1080p and 4K speed paths also the peak of a one-rank
    mesh."""
    m = spatial.spatial_mesh(["cuda:0"] * ranks)

    def run():
        return turbo_spatial.segment_turbo_spatial(image, cfg, m,
                                                   gossip_rounds=rounds)

    (labels, flags), rec = _parallel_counted(path, run)
    dense, dflags = turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS)
    equal = torch.equal(labels, dense)
    ndiff = _oracle_diff(labels, oracle) if oracle is not None else 0
    rec["oracle_pixels_differ"] = ndiff
    print(f"check {path}: flags {flags}, dense flags {dflags}, labels "
          f"equal to dense {equal}"
          + (f", {ndiff} pixels off {oracle.relative_to(ROOT)}"
             if oracle is not None else ""), flush=True)
    if flags or dflags or not equal or ndiff:
        raise AssertionError(f"{path}: spatial labels differ")
    what = _SLAB_WHAT[path]
    tiles = {}
    orig = kg.label_gossip_spatial

    def rec_ld(bits, Lc, idf, dist, *args, **kw):
        rank = int(threading.current_thread().name.rsplit("-", 1)[1])
        tiles.setdefault(rank, (bits.clone(), Lc.clone(), idf.clone()))
        return orig(bits, Lc, idf, dist, *args, **kw)

    kg.label_gossip_spatial = rec_ld
    try:
        with _SlabCapture((0, 1, ranks - 1)) as cap:
            run()
    finally:
        kg.label_gossip_spatial = orig
    _slab_checks(cap.got, what, errs, slab)
    _labelnd_slabs([tiles[r] for r in range(ranks)], (0, 1, ranks - 1),
                   what, errs, slab)
    del cap, tiles
    if path in ("1080p_spatial4", "4k_spatial4"):
        base = _peak_reset()
        one = turbo_spatial.segment_turbo_spatial(
            image, cfg, spatial.spatial_mesh(["cuda:0"]),
            gossip_rounds=rounds)
        rec["peak_mib_one_rank"] = _peak_since(base)
        if not torch.equal(one[0], dense):
            raise AssertionError(f"{path}: one-rank mesh differs")
        print(f"  {path}: peak memory of {ranks} ranks on the card "
              f"{rec['peak_mib']:.1f} MiB ({rec['peak_mib'] / ranks:.1f} a "
              f"rank), of one rank over the whole image "
              f"{rec['peak_mib_one_rank']:.1f} MiB", flush=True)
    _timed(path, run, rec, card, what=f", {ranks} ranks in turn on one "
           "card (not a speed-up figure)")
    return rec


def _spatial_atomic_path(path, images, card):
    """segment_spatial over 4 ranks, or multichip_step on a 2 x 2 mesh over
    the images: root ids byte-equal to segment_atomic on the card, image 0
    0 pixels off the 1080p oracle."""
    cfg = dataclasses.replace(CFG, algorithm="atomic")
    if path == "1080p_spatial_atomic4":
        m = spatial.spatial_mesh(["cuda:0"] * 4)

        def run():
            return spatial.segment_spatial(images[0], cfg, m)[None]
    else:
        batch = torch.stack(images)
        m = Mesh(["cuda:0"] * 4, ("data", "space"), (2, 2))

        def run():
            return torch.cat(spatial.multichip_step(batch, cfg, m))
    labels, rec = _parallel_counted(path, run)
    same = [torch.equal(labels[i], atomic_boruvka.segment_atomic(im, cfg))
            for i, im in enumerate(images)]
    rec["oracle_pixels_differ"] = ndiff = _oracle_diff(labels[0], _WB0)
    print(f"check {path}: root ids equal to segment_atomic {same}; image 0 "
          f"{ndiff} pixels off {_WB0.relative_to(ROOT)}", flush=True)
    if ndiff or not all(same):
        raise AssertionError(f"{path}: labels differ")
    _timed(path, run, rec, card, what=f" for {len(images)} images, ranks "
           "in turn on one card (not a speed-up figure)")
    return rec


def _turns_ab(name, run, card, pairs=2, sync=None):
    """`run` with its mesh's ranks taking turns between collectives (the
    default) and running free (taking no turn, for the run), in
    turns (ABBA) after a warm-up of each, host-clock ms after `sync`
    (default: synchronise cuda:0); equal results. Returns the medians."""
    import gseg_tpu_torch.parallel.mesh as pm

    group = pm._Group
    times, outs = {True: [], False: []}, {}
    sync = sync or torch.cuda.synchronize

    def one(turns):
        if not turns:
            pm._Group = type("FreeGroup", (group,), {
                "take_turn": lambda self: None,
                "end_turn": lambda self: None})
        try:
            t0 = time.perf_counter()
            outs[turns] = run()
            sync()
            return (time.perf_counter() - t0) * 1e3
        finally:
            pm._Group = group

    for turns in (True, False):
        one(turns)
    for i in range(pairs):
        for turns in ((True, False) if i % 2 == 0 else (False, True)):
            times[turns].append(one(turns))
    a, b = outs[True], outs[False]
    if not all(torch.equal(x, y) for x, y in zip(
            a if isinstance(a, (list, tuple)) else [a],
            b if isinstance(b, (list, tuple)) else [b])
            if isinstance(x, torch.Tensor)):
        raise AssertionError(f"{name}: taking turns changed the result")
    med = {"turns": statistics.median(times[True]),
           "free": statistics.median(times[False])}
    print(f"  {name}: ranks taking turns / running free {med['turns']:.3f} "
          f"/ {med['free']:.3f} ms (medians of {pairs}, ABBA, host clock; "
          f"runs {times}) ({card})", flush=True)
    return med


def _parallel_paths(images, card, errs):
    """Step 10: the batch, spatial turbo and spatial atomic paths, each with
    the launch counts set to 0 just before it and read just after. Returns
    (path -> record, the slab checks by step-kernel row)."""
    dev = torch.device("cuda", 0)
    hd = [images[1080, 1920]] + [
        torch.from_numpy(blobs_image(1080, 1920, 31, 8.0, s)).to(dev)
        for s in (1, 2, 3)]
    k4 = [images[2160, 3840],
          torch.from_numpy(blobs_image(2160, 3840, 126, 8.0, 1)).to(dev)]
    small = torch.from_numpy(blobs_image(48, 40, 5, 6.0, 2)).to(dev)
    wb16 = dataclasses.replace(CFG, weight_buckets=16)
    out, slab = {}, {}
    out["1080p_batch4"] = _batch_path("1080p_batch4", hd, _WB0, card)
    out["4k_batch2"] = _batch_path("4k_batch2", k4, _WB0_4K, card)
    out["1080p_spatial4"] = _spatial_turbo_path(
        "1080p_spatial4", hd[0], CFG, 4, 2, _WB0, card, errs, slab)
    m4 = spatial.spatial_mesh(["cuda:0"] * 4)
    out["1080p_spatial4"]["turns_free_ms"] = _turns_ab(
        "1080p_spatial4", lambda: turbo_spatial.segment_turbo_spatial(
            hd[0], CFG, m4, gossip_rounds=GOSSIP_ROUNDS)[0], card)
    errs[PJ] = max(errs[PJ], _join_checks(
        "1080p_spatial4", lambda: turbo_spatial.segment_turbo_spatial(
            hd[0], CFG, m4, gossip_rounds=GOSSIP_ROUNDS))[1])
    out["1080p_spatial4_wb16"] = _spatial_turbo_path(
        "1080p_spatial4_wb16", hd[0], wb16, 4, 2, _WB16, card, errs, slab)
    out["4k_spatial4"] = _spatial_turbo_path(
        "4k_spatial4", k4[0], CFG, 4, 2, _WB0_4K, card, errs, slab)
    out["spatial8_short_tiles"] = _spatial_turbo_path(
        "spatial8_short_tiles", small,
        SegmentationConfig(k=120.0, min_size=8, algorithm="turbo"), 8, 4,
        None, card, errs,
        slab)
    out["1080p_spatial_atomic4"] = _spatial_atomic_path(
        "1080p_spatial_atomic4", hd[:1], card)
    out["1080p_multichip_2x2"] = _spatial_atomic_path(
        "1080p_multichip_2x2", hd, card)
    return out, slab


def _cross_card(card):
    """`python3 chip_smoke.py --cards`, on a machine with several cards:
    the row-sharded paths with one rank on each card (the halos, gathers
    and reductions then peer copies between cards), each card's peak
    memory above what it held before (so each rank's), labels equal to the
    dense paths on cuda:0,
    and median ms of 3 CUDA-event reps after a warm-up (events on every
    card). Returns path -> record."""
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit("chip_smoke.py --cards: needs two or more cards")
    devs = [torch.device("cuda", i) for i in range(n)]
    dev = devs[0]
    hd = torch.from_numpy(blobs_image(1080, 1920, 31, 8.0, 0)).to(dev)
    k4 = torch.from_numpy(blobs_image(2160, 3840, 126, 8.0, 0)).to(dev)
    atomic = dataclasses.replace(CFG, algorithm="atomic")
    wb16 = dataclasses.replace(CFG, weight_buckets=16)
    m = spatial.spatial_mesh(devs)
    cases = {
        "1080p_spatial": (hd, CFG, _WB0),
        "1080p_spatial_wb16": (hd, wb16, _WB16),
        "4k_spatial": (k4, CFG, _WB0_4K),
        "1080p_spatial_atomic": (hd, atomic, _WB0),
    }
    out = {}
    for path, (image, cfg, oracle) in cases.items():
        if cfg.algorithm == "atomic":
            def run(image=image, cfg=cfg):
                return spatial.segment_spatial(image, cfg, m), 0
            dense = atomic_boruvka.segment_atomic(image, cfg), 0
        else:
            def run(image=image, cfg=cfg):
                return turbo_spatial.segment_turbo_spatial(
                    image, cfg, m, gossip_rounds=GOSSIP_ROUNDS)
            dense = turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS)
        bases = [_peak_reset(d) for d in devs]
        labels, flags = run()
        peaks = [_peak_since(b, d) for b, d in zip(bases, devs)]
        ndiff = _oracle_diff(labels, oracle)
        equal = torch.equal(labels, dense[0])

        def timed(run=run):
            run()
            for d in devs:
                torch.cuda.synchronize(d)

        times = []
        timed()
        for _ in range(3):
            t0 = time.perf_counter()
            timed()
            times.append((time.perf_counter() - t0) * 1e3)
        out[path] = {"cards": n, "flags": flags, "equal_dense": equal,
                     "oracle_pixels_differ": ndiff, "peak_mib_by_card": peaks,
                     "main_ms": statistics.median(times)}
        print(f"cards {path}: {n} ranks on {n} cards, flags {flags}, labels "
              f"equal to dense on cuda:0 {equal}, {ndiff} pixels off "
              f"{oracle.relative_to(ROOT)}; peak memory by card (MiB) "
              f"{[round(p, 1) for p in peaks]}; median "
              f"{out[path]['main_ms']:.3f} ms of 3 reps, host clock after "
              f"synchronising every card ({card})", flush=True)
        if flags or ndiff or not equal:
            raise AssertionError(f"--cards {path}: labels differ")

    def sync_all():
        for d in devs:
            torch.cuda.synchronize(d)

    out["1080p_spatial"]["turns_free_ms"] = _turns_ab(
        "cards 1080p_spatial", lambda: turbo_spatial.segment_turbo_spatial(
            hd, CFG, m, gossip_rounds=GOSSIP_ROUNDS)[0], card,
        sync=sync_all)
    batch = torch.stack([hd] + [
        torch.from_numpy(blobs_image(1080, 1920, 31, 8.0, s)).to(dev)
        for s in range(1, n)])
    dm = batching.data_parallel_mesh(devs)
    out["1080p_batch_sharded"] = {"turns_free_ms": _turns_ab(
        f"cards 1080p_batch_sharded ({n} images, one a card)",
        lambda: batching.segment_batch_sharded(batch, CFG, dm), card,
        sync=sync_all)}
    return out


# ---------------------------------------------------------------------------
# step 11: the bench's performance half
# ---------------------------------------------------------------------------

LADDER_REPS = 5
# CUDA-event reps beside the ladder's 1080p and 4K turbo rows: host time
# drifts by tens of percent over a few seconds on a shared host (PERF.md
# §7), so more reps than the ladder's 5 x inner
CUDA_MS_REPS = 25
PROFILE_REPS = 10
PHASE_TIMER_RUNS = 5
PROFILE_TURBO = {"1080p": ["--height", "1080", "--width", "1920"],
                 "4k": ["--height", "2160", "--width", "3840"],
                 "1080p_wb16": ["--height", "1080", "--width", "1920",
                                "--weight-buckets", "16"]}


def _ladder_perf(card):
    """`python -m gseg_tpu_torch.bench perf --algorithms turbo,atomic,
    fastmst --reps 5` in this process, counted as one path: every row's
    flags 0, the rows of every rung and algorithm. Returns (rows, record)."""
    out_dir = FsPath(bench_main.OUT_DIR)
    _reset_counts()
    base = _peak_reset()
    t0 = time.perf_counter()
    with _no_sweeps(LADDER_RUN), _host_reads() as reads:
        rc = bench_main.main(["perf", "--algorithms", ",".join(LADDER_ALGOS),
                              "--reps", str(LADDER_REPS)])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    peak = _peak_since(base)
    with open(out_dir / "perf.jsonl") as f:
        rows = [json.loads(line) for line in f]
    print(f"main path {LADDER_RUN}: exit {rc}, {len(rows)} rows in "
          f"{seconds:.1f} s, launches {launches}, host reads {reads[0]}, "
          f"peak memory {peak:.1f} MiB ({card})", flush=True)
    got = [(r["algorithm"], r["height"], r["width"]) for r in rows]
    if rc or got != list(LADDER.values()):
        raise AssertionError(f"{LADDER_RUN}: exit {rc}, rows {got}")
    flagged = [g for g, r in zip(got, rows) if r["flags"]]
    if flagged:
        raise AssertionError(f"{LADDER_RUN}: rows with flags: {flagged}")
    _check_kernels_run(LADDER_RUN, launches)
    for r in rows:
        t, fg = r["total"], r["filter_graph"]
        print(f"  ladder row {r['algorithm']} {r['height']}x{r['width']}: "
              f"flags {r['flags']}, median {t['median_s'] * 1e3:.3f} ms "
              f"(mean {t['mean_s'] * 1e3:.3f}, min {t['min_s'] * 1e3:.3f}, "
              f"max {t['max_s'] * 1e3:.3f}; {t['reps']} reps x "
              f"{t['inner']}, within 5% {t['within5pct']}) = "
              f"{r['mpix'] / t['median_s']:.2f} MPix/s at the median, "
              f"{r['mpix_per_s']:.2f} at the mean; filter_graph median "
              f"{fg['median_s'] * 1e3:.3f} ms ({card})", flush=True)
    return rows, {"launches": launches, "host_reads": reads[0],
                  "peak_mib": peak, "seconds": seconds}


def _ladder_row_runs(rows, card):
    """One more counted run of every ladder row after the timed reps,
    through the callable the ladder timed (`harness.segment_fn`): launch
    counts 0 just before and read just after (RECORDED_LAUNCHES), host
    reads, peak memory, 0 pixels off the rung's oracle; beside the 1080p
    and 4K turbo rows the same callable's `_cuda_ms` reading. Each rung's
    image is dropped before the next one's is made. Returns name ->
    record."""
    cfg = SegmentationConfig(k=300.0, min_size=100)  # the ladder's
    by = {(r["algorithm"], r["height"], r["width"]): r for r in rows}
    out = {}
    for (h, w), oracle in LADDER_ORACLES.items():
        image = torch.from_numpy(harness.ladder_image(h, w)).cuda()
        for algo in LADDER_ALGOS:
            path = f"ladder_{algo}_{h}x{w}"
            fn = harness.segment_fn(algo, cfg)
            _reset_counts()
            base = _peak_reset()
            with _no_sweeps(path), _host_reads() as reads:
                labels = fn(image)
                torch.cuda.synchronize()
            launches = _counts()
            peak = _peak_since(base)
            ndiff = _oracle_diff(labels, oracle)
            row = by[algo, h, w]
            rec = out[path] = {
                "launches": launches, "host_reads": reads[0],
                "peak_mib": peak, "oracle_pixels_differ": ndiff,
                "median_ms": row["total"]["median_s"] * 1e3,
                "mean_ms": row["total"]["mean_s"] * 1e3,
                "filter_graph_median_ms":
                    row["filter_graph"]["median_s"] * 1e3,
                "flags": row["flags"], "inner": row["total"]["inner"]}
            print(f"main path {path}: launches {launches}, host reads "
                  f"{reads[0]}, peak memory {peak:.1f} MiB; {ndiff} pixels "
                  f"off {oracle.relative_to(ROOT)}", flush=True)
            _check_path_launches(path, launches)
            if ndiff:
                raise AssertionError(f"{path}: partition differs from the "
                                     "oracle")
            if algo == "turbo" and (h, w) in ((1080, 1920), (2160, 3840)):
                _cuda_ms_beside(rec, lambda: fn(image), path, card)
            del labels
        del image
    return out


def _cuda_ms_beside(rec, fn, path, card):
    """The _cuda_ms reading (median CUDA-event ms of CUDA_MS_REPS calls
    after a warm-up) beside the ladder's _timed median, with the host clock
    around the same calls: their per-call gap and range."""
    fn()
    ev, wall = [], []
    for _ in range(CUDA_MS_REPS):
        t0 = time.perf_counter()
        ev.append(_event_ms(fn))
        wall.append((time.perf_counter() - t0) * 1e3)
    rec["cuda_ms"] = statistics.median(ev)
    rec["cuda_ms_wall"] = statistics.median(wall)
    rec["cuda_ms_range"] = [min(ev), max(ev)]
    gap = max(w - e for e, w in zip(ev, wall))
    print(f"  {path}: _timed median {rec['median_ms']:.3f} ms, _cuda_ms "
          f"median of {CUDA_MS_REPS} {rec['cuda_ms']:.3f} ms (ratio "
          f"{rec['median_ms'] / rec['cuda_ms']:.4f}; calls "
          f"{min(ev):.3f}-{max(ev):.3f} ms); the same calls on the host "
          f"clock: median {rec['cuda_ms_wall']:.3f} ms, at most {gap:.3f} ms "
          f"above their events ({card})", flush=True)


def _ladder_1440p_kernels(card, errs):
    """The 1440p rung's main-path fields (2560 wide: the padded route, pad
    and unpad on the bulk route, and on planes offset by one word on the
    register route): every step variant pass by pass with gated passes
    against step_pass_plain, every kernel against its plain version
    (bit-equal) and timed. Returns name -> timing record."""
    path = "ladder_turbo_1440x2560"
    image = torch.from_numpy(harness.ladder_image(1440, 2560)).cuda()
    fields = _capture_main_path_fields(image, CFG)
    missing = {n for n in KERNELS if path in KERNELS[n].must} - set(fields)
    if missing:
        raise AssertionError(f"{path} never called {sorted(missing)}")
    for name in [n for n in STEP if n in fields]:
        args, kwargs = fields[name]
        n, err = _gated_passes(name, args, kwargs)
        errs[name] = max(errs[name], err)
        print(f"check {name} {path} main-path fields {sorted(kwargs)} gated "
              f"passes: {n} passes equal to step_pass_plain", flush=True)
    timed = _time_kernels(fields, f"{path} main-path fields", card, 1)
    for name, rec in timed.items():
        errs[name] = max(errs[name], rec["max_abs_err"])
    return timed


def _profile_turbo(card):
    """`python -m gseg_tpu_torch.bench.profile_turbo` at 1080p and 4K in
    speed mode and at 1080p wb16, with --trace-dir: each prefix's wall
    time beside the device time of one more call under
    `timing.profile_trace`, and each stage's increments. Every prefix's
    flags must be 0. Returns label -> rows."""
    out = {}
    for label, argv in PROFILE_TURBO.items():
        rows = profile_turbo.main(argv + ["--reps", str(PROFILE_REPS),
                                          "--trace-dir", timing.TRACE_DIR])
        bad = [r["phase"] for r in rows if r.get("flags", 0)]
        if bad:
            raise AssertionError(f"profile_turbo {label}: flags in {bad}")
        prev = (0.0, 0.0, 0.0)
        for r in rows:
            wall, low = r["mean_s"] * 1e3, r["min_s"] * 1e3
            dev = r["device_s"] * 1e3
            print(f"  profile_turbo {label} {r['phase']}: wall mean "
                  f"{wall:.1f} ms (+{wall - prev[0]:.1f}), min {low:.1f} "
                  f"(+{low - prev[1]:.1f}); device {dev:.1f} ms "
                  f"(+{dev - prev[2]:.1f}), {dev / low:.3f} of the min; "
                  f"iters {r.get('iters', '-')} ({card})", flush=True)
            prev = (wall, low, dev)
        out[label] = rows
    return out


def _phase_timer(median_s, card):
    """PHASE_TIMER_RUNS PhaseTimer runs at 1080p (prep, segment), one run
    each: their median total must be within 1.5x of the ladder's _timed
    median for the rung. Returns each run's phases."""
    image = torch.from_numpy(harness.ladder_image(1080, 1920)).cuda()
    prep, fn = harness.prep_fn(CFG), harness.segment_fn("turbo", CFG)
    timers = []
    for _ in range(PHASE_TIMER_RUNS):
        timer = timing.PhaseTimer()
        with timer.phase("prep") as o:
            o["result"] = prep(image)[0]
        with timer.phase("segment") as o:
            o["result"] = fn(image)
        timers.append(timer)
        print(f"PhaseTimer 1080p turbo {timer.json()} ({card})", flush=True)
    total = statistics.median(sum(t.phases.values()) for t in timers)
    print(f"PhaseTimer 1080p turbo: median total of {PHASE_TIMER_RUNS} runs "
          f"{total * 1e3:.3f} ms, {total / median_s:.4f} x the ladder's "
          f"_timed median ({card})", flush=True)
    if not 1 / 1.5 <= total / median_s <= 1.5:
        raise AssertionError("PhaseTimer's total is not within 1.5x of "
                             "_timed's median")
    return [t.phases for t in timers]


def _perf_half(card, errs):
    """Step 11: the ladder, PhaseTimer runs (next to the ladder in time:
    host time drifts), the rows against the oracles, the 1440p kernels,
    profile_turbo, fig3 and flagship. Returns (path records, 1440p kernel
    records, step record)."""
    t0 = time.perf_counter()
    gc.collect()  # the earlier steps' profiler events hold cycles
    rows, rec = _ladder_perf(card)
    row, = [r for r in rows if (r["algorithm"], r["height"]) == ("turbo",
                                                                 1080)]
    step = {"phase_timer": _phase_timer(row["total"]["median_s"], card)}
    runs = {LADDER_RUN: rec} | _ladder_row_runs(rows, card)
    timed = _ladder_1440p_kernels(card, errs)
    step["profile_turbo"] = _profile_turbo(card)
    step["fig3"] = fig3.main(["--reps", "100"])
    step["flagship"] = flagship.main([])
    step["seconds"] = time.perf_counter() - t0
    print(f"step 11 took {step['seconds']:.1f} s", flush=True)
    return runs, timed, step


# ---------------------------------------------------------------------------
# step 12: the turbo path's exact alternatives and steps per pass
# ---------------------------------------------------------------------------


class Alt(NamedTuple):
    h: int
    w: int
    weight_buckets: int
    settings: tuple           # ((module, attribute, value), ...): the switch
    oracle: FsPath
    kind: str = "dense"       # "dense", "hierarchy" or "spatial4"
    base: tuple = ()          # settings of the alternative and its default


_GATHER = ((turbo, "_FINAL_GATHER", True),)
_PTR = ((turbo, "_FLOOD_PTR", True),)
ALTERNATIVES = {
    "1080p_final_gather": Alt(1080, 1920, 0, _GATHER, _WB0),
    "4k_final_gather": Alt(2160, 3840, 0, _GATHER, _WB0_4K),
    "1080p_turbo_hierarchy_final_gather": Alt(1080, 1920, 0, _GATHER, _WB0,
                                              "hierarchy"),
    "1080p_spatial4_final_gather": Alt(1080, 1920, 0, _GATHER, _WB0,
                                       "spatial4"),
    "1080p_flood_ptr": Alt(1080, 1920, 0, _PTR, _WB0),
    "4k_flood_ptr": Alt(2160, 3840, 0, _PTR, _WB0_4K),
    "1080p_wb16_rlist_nosplit": Alt(
        1080, 1920, 16, ((turbo, "_RLIST_SPLIT", False),), _WB16),
    "1080p_late_closures": Alt(
        1080, 1920, 0, ((turbo, "_LATE_CLOSURES", True),), _WB0),
    "1080p_wb16_no_q_closures": Alt(
        1080, 1920, 16, ((turbo, "_Q_CLOSURES", False),), _WB16),
    # the reference's _pick_t at w >= 2560
    "4k_t16": Alt(2160, 3840, 0, ((kg, "STEPS_WIDE", 16),), _WB0_4K),
    # the reference's T_SCAN, every hybrid fixpoint on the closure route
    "1080p_wb16_closures_tscan4": Alt(
        1080, 1920, 16, ((kg, "STEPS_SCAN", 4),), _WB16,
        base=((kg, "WARM_PASSES", 0),)),
}
assert set(ALTERNATIVES) == ALT
# the T the step kernel's launches of a path must take (profiler symbols)
ALT_STEPS = {"4k_t16": {16}, "1080p_wb16_closures_tscan4": {4}}
AB_REPS = 3           # CUDA-event calls per median of an A/B entry


@contextlib.contextmanager
def _settings(pairs):
    """Module attributes set while open, restored after."""
    old = [(m, a, getattr(m, a)) for m, a, _ in pairs]
    try:
        for m, a, v in pairs:
            setattr(m, a, v)
        yield
    finally:
        for m, a, v in old:
            setattr(m, a, v)


def _alt_fn(path, image, alt=True):
    """One run of the path's entry point with its switch set (alt) or at
    the default; returns its outputs, flags last."""
    A = ALTERNATIVES[path]
    cfg = dataclasses.replace(CFG, weight_buckets=A.weight_buckets)
    settings = A.base + (A.settings if alt else ())
    if A.kind == "hierarchy":
        def run():
            return turbo.segment_turbo_hierarchy_flagged(image, cfg,
                                                         GOSSIP_ROUNDS)
    elif A.kind == "spatial4":
        mesh = spatial.spatial_mesh(["cuda:0"] * 4)

        def run():
            return turbo_spatial.segment_turbo_spatial(
                image, cfg, mesh, gossip_rounds=GOSSIP_ROUNDS)
    else:
        def run():
            return turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS)

    def fn():
        with _settings(settings):
            return run()
    return fn


def _counted(path, fn):
    """One run with the launch counts set to 0 just before and read just
    after, no plain sweep allowed: (outputs, launches, closure launches by
    orientation, hybrid fixpoints, host reads, peak MiB)."""
    _reset_counts()
    base = _peak_reset()
    with _traced() as traced, _no_sweeps(path), _host_reads() as reads:
        out = fn()
        torch.cuda.synchronize()
    return (out, _counts(), _axis_counts(), _hybrid(traced.rec), reads[0],
            _peak_since(base))


def _launch_steps(fn):
    """The T of every step-kernel launch in one run of fn, by variant
    (kg._launch_pass recorded)."""
    launch, out = kg._launch_pass, {}

    def rec(variant, *args):
        out.setdefault(variant, set()).add(args[-1])
        return launch(variant, *args)
    kg._launch_pass = rec
    try:
        fn()
    finally:
        kg._launch_pass = launch
    return out


def _ab_pairs(fa, fb, reps=AB_REPS, pairs=2):
    """`pairs` A B B A pairs, each entry the median CUDA-event ms of `reps`
    calls, after a warm-up call of each. Returns (A medians, B medians)."""
    fa()
    fb()
    a, b = [], []
    for _ in range(pairs):
        for fn, out in ((fa, a), (fb, b), (fb, b), (fa, a)):
            out.append(statistics.median(_event_ms(fn) for _ in range(reps)))
    return a, b


def _alt_path(path, image, dense, card, unrecorded):
    """The counted run of one alternative: flags 0, 0 pixels off its
    oracle, its recorded launches (a path without a record is listed in
    `unrecorded`), every kernel it must run and none it must not; the
    hierarchy's levels against the level oracle, the row-sharded labels
    against the dense ones, the T of its step launches where the switch
    sets one; then host reads and peak memory of the default, and two
    A B B A pairs of the default (A) and the alternative (B). Returns the
    record."""
    A = ALTERNATIVES[path]
    fn, base_fn = _alt_fn(path, image), _alt_fn(path, image, alt=False)
    out, launches, axis, hybrid, reads, peak = _counted(path, fn)
    labels, flags = out[-2], out[-1]
    ndiff = _oracle_diff(labels, A.oracle)
    print(f"main path {path}: flags {flags}, launches {launches}, closure "
          f"launches (rows, columns) {axis}, {len(hybrid)} hybrid fixpoints "
          f"(variant, step passes, pairs) {hybrid}; host reads {reads}, "
          f"peak memory {peak:.1f} MiB; oracle partition "
          f"({A.oracle.relative_to(ROOT)}): {ndiff} pixels differ",
          flush=True)
    if flags or ndiff:
        raise AssertionError(f"{path}: flags {flags}, {ndiff} pixels off "
                             "the oracle")
    if path in RECORDED_LAUNCHES:
        _check_launches(path, launches)
    else:
        unrecorded[path] = launches
    _check_kernels_run(path, launches)
    rec = {"launches": launches, "host_reads": reads, "peak_mib": peak,
           "hybrid_variant_steps_pairs": hybrid,
           "closure_launches_rows_cols": axis,
           "oracle_pixels_differ": ndiff}
    if A.kind == "hierarchy":
        ref = load_level_oracle(LEVEL_ORACLE)["levels"]
        stats = [_level_stats(_canonical(lv)) for lv in out[0]]
        bad = [i for i, ((n, sha), r) in enumerate(zip(stats, ref))
               if sha != r["sha256"]]
        print(f"  check levels {path}: {len(stats)} levels, "
              f"{len(stats) - len(bad)} equal to the level oracle "
              f"(gseg_tpu_torch/oracles/{LEVEL_ORACLE}.json)", flush=True)
        if bad or len(stats) != len(ref):
            raise AssertionError(f"{path}: levels {bad} differ")
    if A.kind == "spatial4":
        same = torch.equal(labels, dense)
        print(f"  {path}: labels equal to the dense path's: {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{path}: labels differ from dense")
    if path == "4k_t16":
        pads = _wrapper_calls(PADS, fn)
        ts = {args[1] for calls in pads.values() for args, _ in calls}
        print(f"  {path}: pad/unpad at t {sorted(ts)}", flush=True)
        if ts != {16}:
            raise AssertionError(f"{path}: pads at t {ts}")
    if path in ALT_STEPS:
        by = _launch_steps(fn)
        print(f"  {path}: step launches at T, by variant "
              f"{ {v: sorted(ts) for v, ts in by.items()} }", flush=True)
        if set().union(*by.values()) != ALT_STEPS[path]:
            raise AssertionError(f"{path}: step launches at T {by}")
    _, _, _, _, base_reads, base_peak = _counted(path, base_fn)
    a, b = _ab_pairs(base_fn, fn)
    rec |= {"ab_default_ms": a, "ab_alternative_ms": b,
            "default_host_reads": base_reads, "default_peak_mib": base_peak}
    print(f"  A/B {path} (A the default, B the alternative; two A B B A "
          f"pairs, medians of {AB_REPS} CUDA-event calls): A {_r(a)} ms, "
          f"B {_r(b)} ms, B/A of the medians "
          f"{statistics.median(b) / statistics.median(a):.4f}; host reads "
          f"A {base_reads} B {reads}; peak memory A {base_peak:.1f} B "
          f"{peak:.1f} MiB ({card})", flush=True)
    return rec


def _r(xs):
    return [round(x, 3) for x in xs]


def _t_bound_ms(name, h, w, t):
    """Least time of one ungated t-step launch over an (h, w) plane at the
    HBM rate: every tile loads its (TILE + 2t)^2 slab of the read-only
    plane and each read-write field once, and writes its interior's
    fields once."""
    nrw = len(kg._VARIANTS[STEP[name]][2])
    tiles = -(-h // kg._TILE) * -(-w // kg._TILE)
    nbytes = tiles * 4 * ((kg._TILE + 2 * t) ** 2 * (nrw + 1)
                          + kg._TILE ** 2 * nrw)
    return nbytes / HBM_BYTES_PER_S * 1e3


def _timed_passes(times):
    """A `passes` for kg._run_fixpoint: its step-only passes by the kernel,
    tile skipping as configured, each launch's device ms (CUDA events
    behind a device sleep) appended to `times`."""
    def passes(variant, ro, fields, max_passes, closures, seed_act, t):
        if closures:
            raise ValueError("_timed_passes drives step-only fixpoints")
        tiles = (-(-ro.shape[0] // kg._TILE), -(-ro.shape[1] // kg._TILE))
        bufs = [[torch.empty_like(x) for x in fields] for _ in range(2)]
        acts = [torch.empty(tiles, dtype=torch.uint8, device=ro.device)
                for _ in range(2)]
        changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
        stream = torch.cuda.current_stream().cuda_stream

        def step(src, dst, act_in, act_out):
            times.append(_device_event_ms(lambda: kg._launch_pass(
                variant, ro, src, dst, act_in, act_out, changed, stream, t)))
        out, unconv, _, _ = kg._pass_loop(
            step, None, fields, bufs, acts, changed, max_passes, max_passes,
            seed_act, kg.TILE_SKIP)
        return out, unconv
    return passes


def _steps_per_pass(fields, card, errs):
    """The step kernel at each T of kg.STEP_COUNTS on the main-path fields
    of 1080p and 4K: at 4K every variant's fixpoint pass by pass against
    step_pass_plain at T (4, 16, 32; 8 and the 1080p fields are step 3's);
    then at both sizes the fixpoint through the wrappers' own route
    (`kg._run_fixpoint`: 1080p at kg.STEPS = T, 4K padded at
    kg.STEPS_WIDE = T), equal to the plain fixpoint, with each launch's
    device ms (CUDA events behind a device sleep): its launches, device
    ms a call and a launch, and the bound of one ungated launch at T.
    Returns variant name -> size -> T -> record."""
    out = {name: {} for name in STEP}
    for size, flds, attr in (("1080p", fields["1080p"], "STEPS"),
                             ("4k", fields["4k"], "STEPS_WIDE")):
        for name in STEP:
            args, kwargs = flds[name]
            ro, *planes, ms = args
            ref = KERNELS[name].plain(*args)
            for t in kg.STEP_COUNTS:
                if t != kg.STEPS and size == "4k":
                    n, err = _gated_passes(name, args, kwargs, t, ref)
                    errs[name] = max(errs[name], err)
                    print(f"check {name} {size} main-path fields T={t} "
                          f"gated passes: {n} passes equal to "
                          "step_pass_plain", flush=True)
                times = []
                with _settings(((kg, attr, t),)):
                    got, unconv = kg._run_fixpoint(
                        STEP[name], ro, planes, ms, False,
                        kwargs.get("seed_mask"), passes=_timed_passes(times))
                errs[name] = max(errs[name], _max_abs_err(got, ref[:-1]))
                if unconv or ref[-1]:
                    raise AssertionError(f"{name} {size} T={t}: a fixpoint "
                                         "hit its cap")
                ms_call = sum(times)
                rec = out[name].setdefault(size, {})[t] = {
                    "device_ms_fixpoint": ms_call, "launches": len(times),
                    "device_ms_launch": ms_call / len(times),
                    "bound_ms_launch": _t_bound_ms(name, *ro.shape, t)}
                print(f"  {name} {size} T={t}: equal to plain; "
                      f"{len(times)} launches, device {ms_call:.4f} ms a "
                      f"fixpoint, {rec['device_ms_launch']:.4f} ms a launch; "
                      f"bound of an ungated launch "
                      f"{rec['bound_ms_launch']:.4f} ms (bytes) ({card})",
                      flush=True)
    return out


def _alternatives(images, card, errs):
    """Step 12: the step kernel at T 4, 16 and 32 pass by pass at
    RANDOM_SHAPES and at the 1080p and 4K main-path fields, its device ms
    per T; then each alternative path (ALTERNATIVES) counted and timed
    against its default. Returns (path records, step record)."""
    t0 = time.perf_counter()
    dev = images[1080, 1920].device
    for h, w in RANDOM_SHAPES:
        args = _random_args(h, w, dev, seed=h * 7 + w)
        refs = {name: KERNELS[name].plain(*args[name]) for name in STEP}
        for t in kg.STEP_COUNTS:
            if t == kg.STEPS:
                continue
            passes = {}
            for name in STEP:
                passes[name], err = _gated_passes(name, args[name], None, t,
                                                  refs[name])
                errs[name] = max(errs[name], err)
            print(f"check step kernel {h}x{w} T={t}: every variant's gated "
                  f"passes equal to step_pass_plain ({passes} passes) at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"step 12 random shapes done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    fields = {"1080p": _capture_main_path_fields(images[1080, 1920], CFG),
              "4k": _capture_main_path_fields(images[2160, 3840], CFG)}
    step = {"steps_per_pass": _steps_per_pass(fields, card, errs)}
    del fields
    print(f"step 12 steps per pass done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dense = turbo.segment_turbo_flagged(images[1080, 1920], CFG,
                                        GOSSIP_ROUNDS)[0]
    runs, unrecorded = {}, {}
    for path, A in ALTERNATIVES.items():
        runs[path] = _alt_path(path, images[A.h, A.w], dense, card,
                               unrecorded)
    if unrecorded:
        raise AssertionError(f"launches of paths with no record: "
                             f"{unrecorded}")
    step["seconds"] = time.perf_counter() - t0
    print(f"step 12 took {step['seconds']:.1f} s ({card})", flush=True)
    return runs, step


# ---------------------------------------------------------------------------
# step 13: the reference's hardware parity protocol (bench.parity,
# bench.spatial_parity) and the rows of its record the card had not run
# ---------------------------------------------------------------------------

STEP13_REPS = 3       # _timed reps of a row, one call each
SPATIAL_REPS = 2      # ... of a row-sharded row (0.4-3.8 s a call)
PARITY_RUN = "parity_protocol"
SPATIAL_RUN = "spatial_parity_protocol"
BIG_RUN = "ladder_5k_8k"
TEXTURED_RUN = "ladder_textured"
BIG_RUNGS = {(2880, 5120): "blobs_2880x5120_wb0",
             (4320, 7680): "blobs_4320x7680_wb0"}
TEXTURED_RUNGS = {(540, 960): "textured_540x960_wb0",
                  (1080, 1920): "textured_1080x1920_wb0",
                  (2160, 3840): "textured_2160x3840_wb0"}


def _parity_path(case_name):
    return "parity_" + case_name.replace(" ", "_")


PARITY_PATHS = [_parity_path(c) for c in
                [f"synthetic{s:03d}" for s in range(20)]
                + ["540p blobs", "540p textured", "1080p textured k10 wb16"]]
# (content, h, w, ranks, weight_buckets) -> the row-sharded and the dense
# run's path
SPATIAL_ROWS = {
    (c, h, w, n, wb): (f"spatial_parity_{c}_{h}x{w}_{n}ranks_wb{wb}",
                       f"spatial_parity_dense_{c}_{h}x{w}_wb{wb}")
    for h, w, n in spatial_parity.PLAN for c in spatial_parity.CONTENTS
    for wb in spatial_parity.WEIGHT_BUCKETS}


def _ladder_path(algo, h, w, content):
    return (f"ladder_{algo}_{h}x{w}" if content == "blobs"
            else f"ladder_{algo}_{content}_{h}x{w}")


# each run of a whole module -> the rows it holds
STEP13_RUNS = {
    PARITY_RUN: PARITY_PATHS,
    SPATIAL_RUN: [p for pair in SPATIAL_ROWS.values() for p in pair],
    BIG_RUN: [_ladder_path(a, h, w, "blobs") for h, w in BIG_RUNGS
              for a in LADDER_ALGOS],
    TEXTURED_RUN: [_ladder_path("turbo", h, w, "textured")
                   for h, w in TEXTURED_RUNGS]}
# the module runs whose launches are the sum of their rows' (the ladders'
# timed calls vary in number with the host)
STEP13_SUMS = {PARITY_RUN, SPATIAL_RUN}


def _turbo_launches(compmin, labeldist, labelnd, value, subsum, extract=1,
                    pads=0, **closures):
    return (dict(gossip_compmin=compmin, gossip_labeldist=labeldist,
                 gossip_labelnd=labelnd, gossip_value=value,
                 gossip_subsum=subsum, boundary_extract=extract,
                 pad_fields=pads, unpad_fields=pads) | closures)


# step 13 (run 13a). The sweep's seeds (compmin, label+dist = subsum,
# labelnd, value; one extract each): stage G's rounds vary with the seed,
# seed 5 taking 69 compmin passes. The row-sharded rows count slab passes
# summed over the ranks (no labelnd, closure, pad or extract); the dense
# quality-mode rows at 540p and 720p run the closures (their hybrid
# fixpoints pass the warm passes), as no earlier path at the default
# WARM_PASSES did. 5K and 8K take the padded route: pad and unpad 10 each
# on turbo, 1 on fastmst.
SWEEP_LAUNCHES = (
    (18, 7, 26, 11), (11, 7, 15, 8), (19, 8, 24, 11), (19, 7, 25, 11),
    (19, 7, 29, 14), (69, 7, 67, 21), (12, 7, 16, 9), (17, 7, 24, 11),
    (10, 7, 17, 8), (19, 7, 26, 11), (18, 7, 25, 11), (22, 7, 30, 16),
    (24, 8, 30, 13), (12, 7, 15, 9), (12, 7, 16, 8), (18, 7, 26, 12),
    (11, 7, 15, 8), (17, 7, 26, 14), (19, 7, 24, 13), (12, 7, 13, 7))
RECORDED_LAUNCHES |= {
    path: ("13a", _turbo_launches(c, ld, lnd, v, ld))
    for path, (c, ld, lnd, v) in zip(PARITY_PATHS, SWEEP_LAUNCHES)}
RECORDED_LAUNCHES |= {p: ("13a", launches) for p, launches in {
    "parity_540p_blobs": _turbo_launches(14, 8, 17, 9, 8),
    "parity_540p_textured": _turbo_launches(13, 8, 19, 11, 8),
    "parity_1080p_textured_k10_wb16": _turbo_launches(64, 0, 128, 37, 0),
    "spatial_parity_dense_blobs_540x960_wb0": _turbo_launches(
        14, 8, 17, 9, 8),
    "spatial_parity_blobs_540x960_4ranks_wb0": _turbo_launches(
        56, 112, 0, 36, 112, extract=0),
    "spatial_parity_dense_blobs_540x960_wb16": _turbo_launches(
        96, 0, 183, 63, 0, closure_labelnd=8),
    "spatial_parity_blobs_540x960_4ranks_wb16": _turbo_launches(
        384, 808, 0, 252, 784, extract=0),
    "spatial_parity_dense_textured_540x960_wb0": _turbo_launches(
        13, 8, 19, 11, 8),
    "spatial_parity_textured_540x960_4ranks_wb0": _turbo_launches(
        52, 112, 0, 44, 112, extract=0),
    "spatial_parity_dense_textured_540x960_wb16": _turbo_launches(
        51, 0, 93, 27, 0),
    "spatial_parity_textured_540x960_4ranks_wb16": _turbo_launches(
        204, 372, 0, 108, 360, extract=0),
    "spatial_parity_dense_blobs_720x1280_wb0": _turbo_launches(
        13, 8, 19, 10, 8),
    "spatial_parity_blobs_720x1280_8ranks_wb0": _turbo_launches(
        104, 240, 0, 80, 240, extract=0),
    "spatial_parity_dense_blobs_720x1280_wb16": _turbo_launches(
        145, 0, 244, 66, 0, closure_labelnd=16, closure_value=2),
    "spatial_parity_blobs_720x1280_8ranks_wb16": _turbo_launches(
        1160, 2336, 0, 520, 2336, extract=0),
    "spatial_parity_dense_textured_720x1280_wb0": _turbo_launches(
        13, 8, 21, 10, 8),
    "spatial_parity_textured_720x1280_8ranks_wb0": _turbo_launches(
        104, 240, 0, 80, 232, extract=0),
    "spatial_parity_dense_textured_720x1280_wb16": _turbo_launches(
        100, 0, 185, 47, 0, closure_labelnd=8),
    "spatial_parity_textured_720x1280_8ranks_wb16": _turbo_launches(
        800, 1512, 0, 376, 1320, extract=0),
    "ladder_turbo_2880x5120": _turbo_launches(20, 9, 28, 19, 9, pads=10),
    "ladder_atomic_2880x5120": {},
    "ladder_fastmst_2880x5120": dict(gossip_value=3, pad_fields=1,
                                     unpad_fields=1),
    "ladder_turbo_4320x7680": _turbo_launches(22, 9, 31, 24, 9, pads=10),
    "ladder_atomic_4320x7680": {},
    "ladder_fastmst_4320x7680": dict(gossip_value=3, pad_fields=1,
                                     unpad_fields=1),
    "ladder_turbo_textured_540x960": _turbo_launches(13, 8, 19, 11, 8),
    "ladder_turbo_textured_1080x1920": _turbo_launches(13, 8, 19, 10, 8),
    "ladder_turbo_textured_2160x3840": _turbo_launches(13, 8, 19, 9, 8,
                                                       pads=10),
}.items()}


def _step13_launches(path, launches, unrecorded):
    """A row's launches against its record (exact: every kernel it
    recorded launched, no other); a row without one is listed in
    `unrecorded`. A whole-module run must launch the kernels its rows
    recorded and no other, and where its calls are its rows' (STEP13_SUMS)
    the sum of their records."""
    if path in MODULE_RUNS:
        rows = MODULE_RUNS[path]
        if not all(r in RECORDED_LAUNCHES for r in rows):
            return
        if path in STEP13_SUMS:
            want = {n: sum(RECORDED_LAUNCHES[r][1].get(n, 0) for r in rows)
                    for n in KERNELS}
            if launches != want:
                raise AssertionError(f"{path}: launches {launches}, the sum "
                                     f"of its rows' records {want}")
        want = {n for r in rows for n, c in RECORDED_LAUNCHES[r][1].items()
                if c}
        got = {n for n, c in launches.items() if c}
        if got != want:
            raise AssertionError(f"{path}: launched {sorted(got)}, its rows "
                                 f"recorded {sorted(want)}")
    elif path in RECORDED_LAUNCHES:
        _check_launches(path, launches)
    else:
        unrecorded[path] = launches


def _step13_row(path, fn, card, unrecorded, pixels, reps=STEP13_REPS):
    """One counted call of a row's callable (returns the outputs), its
    launches against the record, host reads and peak memory; then its
    _timed median of `reps` calls, unless `reps` is 0. Returns (outputs,
    record)."""
    out, launches, _, _, reads, peak = _counted(path, fn)
    _step13_launches(path, launches, unrecorded)
    rec = {"launches": launches, "host_reads": reads, "peak_mib": peak}
    if reps:
        t = harness._timed(fn, reps, inner=1)
        rec |= {"median_ms": t["median_s"] * 1e3, "reps": reps,
                "mpix_per_s": pixels / 1e6 / t["median_s"]}
    return out, rec


def _row_line(path, rec, card, what):
    timed = (f"; _timed median {rec['median_ms']:.3f} ms of {rec['reps']} "
             f"reps = {rec['mpix_per_s']:.2f} MPix/s"
             if "median_ms" in rec else "")
    print(f"main path {path}: {what}; launches {rec['launches']}, host "
          f"reads {rec['host_reads']}, peak memory {rec['peak_mib']:.1f} "
          f"MiB{timed} ({card})", flush=True)


def _module_run(path, fn, card):
    """A whole module's run in this process, counted as one path."""
    t0 = time.perf_counter()
    out, launches, _, _, reads, peak = _counted(path, fn)
    seconds = time.perf_counter() - t0
    print(f"main path {path}: {seconds:.1f} s, launches {launches}, host "
          f"reads {reads}, peak memory {peak:.1f} MiB ({card})", flush=True)
    return out, {"launches": launches, "host_reads": reads,
                 "peak_mib": peak, "seconds": seconds}


def _parity_rows(dev, card, unrecorded):
    """`bench.parity` whole (it raises SystemExit on any failure), then
    every row counted and timed."""
    _, rec = _module_run(PARITY_RUN, lambda: parity.main([]), card)
    runs = {PARITY_RUN: rec}
    for case, path in zip(parity.cases(), PARITY_PATHS):
        h, w = case.image.shape[:2]
        row, rec = _step13_row(path, lambda: parity.check(case, dev), card,
                               unrecorded, h * w, reps=0)
        image = torch.from_numpy(case.image).to(dev)
        t = harness._timed(lambda: turbo.segment_turbo_flagged(
            image, case.cfg, GOSSIP_ROUNDS)[0], STEP13_REPS, inner=1)
        rec |= {"flags": row["flags"], "oracle_pixels_differ":
                row["pixels_differ"], "components": row["components"],
                "median_ms": t["median_s"] * 1e3, "reps": STEP13_REPS,
                "mpix_per_s": h * w / 1e6 / t["median_s"]}
        _row_line(path, rec, card, f"flags {row['flags']}, "
                  f"{row['components']} components, {row['pixels_differ']} "
                  "pixels off the oracle")
        if row["flags"] or not row["equal"]:
            raise AssertionError(f"{path}: {row}")
        runs[path] = rec
    return runs


def _spatial_rows(dev, card, unrecorded):
    """`bench.spatial_parity` whole (exit 0, its JSON rows equal with
    flags 0), then every row's dense and row-sharded runs counted, the
    row-sharded one timed: labels equal, flags 0."""
    rc, rec = _module_run(SPATIAL_RUN, lambda: spatial_parity.main([]),
                          card)
    with open(spatial_parity.OUT) as f:
        record = json.load(f)
    bad = [r for r in record["rows"] if not spatial_parity.row_ok(r)]
    if rc or bad or len(record["rows"]) != len(SPATIAL_ROWS):
        raise AssertionError(f"{SPATIAL_RUN}: exit {rc}, rows {bad}")
    runs = {SPATIAL_RUN: rec | {"rows": record["rows"]}}
    for (content, h, w, n, wb), (path, dense_path) in SPATIAL_ROWS.items():
        image = torch.from_numpy(harness.ladder_image(h, w, content)).to(dev)
        cfg = spatial_parity.config(wb)
        mesh = spatial.spatial_mesh([dev] * n)
        (dense, dflags), drec = _step13_row(
            dense_path, lambda: turbo.segment_turbo_flagged(
                image, cfg, GOSSIP_ROUNDS), card, unrecorded, h * w, reps=0)
        _row_line(dense_path, drec, card, f"flags {dflags}")
        (labels, flags), rec = _step13_row(
            path, lambda: turbo_spatial.segment_turbo_spatial(
                image, cfg, mesh, "space", GOSSIP_ROUNDS), card,
            unrecorded, h * w, reps=SPATIAL_REPS)
        same = torch.equal(labels, dense)
        rec |= {"flags": flags, "dense_flags": dflags, "equal": same}
        _row_line(path, rec, card, f"flags {flags}, labels equal to the "
                  f"dense path's: {same}")
        if flags or dflags or not same:
            raise AssertionError(f"{path}: flags {flags}, dense flags "
                                 f"{dflags}, equal {same}")
        runs[path], runs[dense_path] = rec, drec
    return runs


def _ladder_rows(run, rungs, algos, content, dev, card, unrecorded):
    """`run_performance_ladder` over `rungs` (rung -> oracle name) for
    `algos` on `content`, counted as the path `run` (every row flags 0),
    then each row once more, counted, 0 pixels off its rung's oracle."""
    rows, rec = _module_run(run, lambda: harness.run_performance_ladder(
        algos, list(rungs), STEP13_REPS, content=content, device=dev), card)
    runs = {run: rec}
    flagged = [(r["algorithm"], r["height"], r["width"]) for r in rows
               if r["flags"]]
    if flagged or len(rows) != len(rungs) * len(algos):
        raise AssertionError(f"{run}: {len(rows)} rows, flags in {flagged}")
    by = {(r["algorithm"], r["height"], r["width"]): r for r in rows}
    cfg = SegmentationConfig(k=300.0, min_size=100)  # the ladder's
    for (h, w), name in rungs.items():
        image = torch.from_numpy(harness.ladder_image(h, w, content)).to(dev)
        oracle = FsPath(oracle_path(name)).resolve()
        for algo in algos:
            path = _ladder_path(algo, h, w, content)
            labels, rec = _step13_row(path, lambda: harness.segment_fn(
                algo, cfg, device=dev)(image), card, unrecorded, h * w,
                reps=0)
            row = by[algo, h, w]
            t = row["total"]
            rec |= {"flags": row["flags"], "median_ms": t["median_s"] * 1e3,
                    "reps": t["reps"], "mean_ms": t["mean_s"] * 1e3,
                    "inner": t["inner"],
                    "mpix_per_s": row["mpix"] / t["median_s"],
                    "filter_graph_median_ms":
                        row["filter_graph"]["median_s"] * 1e3,
                    "oracle_pixels_differ": _oracle_diff(labels, oracle)}
            _row_line(path, rec, card, f"flags {row['flags']}, "
                      f"{rec['oracle_pixels_differ']} pixels off "
                      f"{oracle.relative_to(ROOT)}")
            if rec["oracle_pixels_differ"]:
                raise AssertionError(f"{path}: partition differs from the "
                                     "oracle")
            runs[path] = rec
            del labels
        del image
    return runs


@contextlib.contextmanager
def _images_once():
    """`harness.ladder_image` (and the parity modules' references to it)
    makes each (h, w, content) once while open, so that a module's run and
    its rows' runs share their images: on the host an 8K blobs image takes
    tens of seconds."""
    made, make = {}, harness.ladder_image

    def once(h, w, content="blobs"):
        if (h, w, content) not in made:
            made[h, w, content] = make(h, w, content)
        return made[h, w, content]

    mods = (harness, parity, spatial_parity)
    for m in mods:
        m.ladder_image = once
    try:
        yield
    finally:
        for m in mods:
            m.ladder_image = make


def _parity_step(dev, card):
    """Step 13. Returns (path records, step record)."""
    t0 = time.perf_counter()
    gc.collect()
    unrecorded, step = {}, {}
    with _images_once():
        runs = _parity_rows(dev, card, unrecorded)
        step["parity_s"] = time.perf_counter() - t0
        runs |= _spatial_rows(dev, card, unrecorded)
        step["spatial_s"] = time.perf_counter() - t0 - step["parity_s"]
        runs |= _ladder_rows(BIG_RUN, BIG_RUNGS, LADDER_ALGOS, "blobs", dev,
                             card, unrecorded)
        runs |= _ladder_rows(TEXTURED_RUN, TEXTURED_RUNGS, ("turbo",),
                             "textured", dev, card, unrecorded)
    for path in STEP13_RUNS:
        _step13_launches(path, runs[path]["launches"], unrecorded)
    step["seconds"] = time.perf_counter() - t0
    print(f"step 13 took {step['seconds']:.1f} s ({card})", flush=True)
    if unrecorded:
        print("unrecorded launches: " + json.dumps(unrecorded), flush=True)
        raise AssertionError(f"launches of paths with no record: "
                             f"{sorted(unrecorded)}")
    return runs, step


# ---------------------------------------------------------------------------
# step 14: the reference's evidence campaign and knob sweep (bench.sweep,
# bench.evidence, bench.summarize) on the rows the card had not run
# ---------------------------------------------------------------------------

STEP14_OUT = ROOT / "bench_out" / "torch" / "step14"
SWEEP_REPS = 3        # _timed reps of a sweep row, one call each
STEP14_REPS = 3       # ... of a new ladder row (the harness picks inner)
# module run -> ((h, w), weight_buckets, configs)
SWEEP_RUNS = {
    "sweep_1080p_wb0": ((1080, 1920), 0, tuple(
        c for c in sweep.CONFIGS if c not in sweep.QUALITY_CONFIGS)),
    "sweep_1080p_wb16": ((1080, 1920), 16,
                         ("baseline",) + sweep.QUALITY_CONFIGS),
    "sweep_4k_wb0": ((2160, 3840), 0, ("baseline", "nofastpad")),
}
# (config, weight_buckets) whose checked call may raise FLAG_PAIR_OVERFLOW
# at 1080p, and only through the candidate pool at the reference's
# capacity (`turbo.capacities`: cap_live V at gate 13, V/2 in quality
# mode): the reference's Pallas path recorded the same overflow
# (bench_out/sweep.jsonl), its XLA path has no candidate pool.
SWEEP_MAY_OVERFLOW = {("gate13", 0), ("gateq8", 16), ("gateq8nc", 16)}
# the ladder rows of the reference's record the card had not run
EVIDENCE_RUN = "evidence_perf_new_rows"
NEW_LADDERS = [("superpixel", [0, 1, 2], {}, "blobs"),
               ("atomic_hostsync", [0], {}, "blobs"),
               ("turbo_wb16", [0], {"weight_buckets": 16}, "blobs")]
QUALITY_SET_RECORD = ROOT / "bench_out/quality.jsonl"
SYNTHETIC_PIXELS = 161 * 241  # an image of synthetic_quality_set


def _sweep_path(config, h, w, wb):
    return f"sweep_{config}_{h}x{w}_wb{wb}"


def _synthetic_path(name):
    return f"synthetic_quality_{name}"


# step 14 (run 14a). A sweep row's launches are those of its checked
# warm-up call: the 1080p defaults are 1080p_subsum's and 1080p_wb16's,
# 4K's 4k_subsum's; an early gate hands off after fewer rounds (gate 13
# and gate_q 8 up to their candidate pool's overflow); the pointer flood
# drops the root-list rounds' label floods, the gather the final map's
# value floods; nofastpad at 4K runs the same passes unpadded. No closure
# launches at the default warm passes, not even with `_LATE_CLOSURES`.
# The synthetic set's turbo rows are the parity sweep's seeds (step 13)
# summed; none took the atomic fallback.
_SWEEP_1080P = _turbo_launches(16, 8, 23, 17, 8)
_SWEEP_WB16 = _turbo_launches(114, 0, 179, 46, 0)
_SWEEP_4K = _turbo_launches(18, 8, 21, 17, 8, pads=10)
RECORDED_LAUNCHES |= {p: ("14a", launches) for p, launches in {
    "sweep_baseline_1080x1920_wb0": _SWEEP_1080P,
    "sweep_nosmall_1080x1920_wb0": _SWEEP_1080P,
    "sweep_gate13_1080x1920_wb0": _turbo_launches(3, 8, 0, 4, 8),
    "sweep_gate32_1080x1920_wb0": _turbo_launches(7, 8, 8, 9, 8),
    "sweep_closures_1080x1920_wb0": _SWEEP_1080P,
    "sweep_peelcount_1080x1920_wb0": _turbo_launches(16, 0, 31, 17, 0),
    "sweep_nofastpad_1080x1920_wb0": _SWEEP_1080P,
    "sweep_floodptr_1080x1920_wb0": _turbo_launches(16, 8, 0, 17, 8),
    "sweep_finalgather_1080x1920_wb0": _turbo_launches(16, 8, 23, 0, 8),
    "sweep_floodptr_fg_1080x1920_wb0": _turbo_launches(16, 8, 0, 0, 8),
    "sweep_baseline_1080x1920_wb16": _SWEEP_WB16,
    "sweep_gateq16_1080x1920_wb16": _turbo_launches(77, 0, 125, 37, 0),
    "sweep_gateq8_1080x1920_wb16": _turbo_launches(26, 0, 49, 16, 0),
    "sweep_qnoclosures_1080x1920_wb16": _SWEEP_WB16,
    "sweep_gateq8nc_1080x1920_wb16": _turbo_launches(26, 0, 49, 16, 0),
    "sweep_baseline_2160x3840_wb0": _SWEEP_4K,
    "sweep_nofastpad_2160x3840_wb0": _SWEEP_4K | dict(pad_fields=0,
                                                      unpad_fields=0),
    "synthetic_quality_turbo": _turbo_launches(378, 142, 489, 226, 142,
                                               extract=20),
    "synthetic_quality_turbo_wb16": _turbo_launches(2876, 0, 3044, 414, 0,
                                                    extract=20),
    "synthetic_quality_fastmst": dict(gossip_value=40),
    "synthetic_quality_atomic": {},
    "synthetic_quality_superpixel": dict(gossip_value=42,
                                         ordered_scatter_add=80),
    "synthetic_quality_kruskal_native": {},
    "synthetic_quality_boruvka_cpu": {},
    "ladder_superpixel_540x960": dict(gossip_value=2, ordered_scatter_add=4),
    "ladder_superpixel_720x1280": dict(gossip_value=3,
                                       ordered_scatter_add=4),
    "ladder_superpixel_1080x1920": dict(gossip_value=3,
                                        ordered_scatter_add=4),
    "ladder_atomic_hostsync_540x960": {},
    "ladder_turbo_wb16_540x960": _turbo_launches(96, 0, 183, 63, 0,
                                                 closure_labelnd=8),
}.items()}


STEP14_RUNS = {
    run: [_sweep_path(c, h, w, wb) for c in configs]
    for run, ((h, w), wb, configs) in SWEEP_RUNS.items()} | {
    EVIDENCE_RUN: [
        _ladder_path(name, *harness.RESOLUTION_LADDER[i], content)
        for name, rungs, _, content in NEW_LADDERS for i in rungs]}
MODULE_RUNS = STEP13_RUNS | STEP14_RUNS


def _handoff_probe(image, cfg):
    """One flagged turbo call with the handoff recorded: the candidate
    pool's count, capacity and overflow (`boundary_extract`) and the pair
    pool's live pairs, capacity and overflow (the first compaction after
    the extraction). Returns (flags, record)."""
    rec = {}
    extract, select = kx.boundary_extract, turbo._select_compact

    def extract_rec(L, weights, cap):
        out = extract(L, weights, cap)
        rec.update(candidates=int(out[4]), cap_live=cap,
                   candidate_overflow=bool(out[5]))
        return out

    def select_rec(mask, keys, cap):
        out = select(mask, keys, cap)
        if "pairs" not in rec:
            rec.update(pairs=int(mask.sum()), pair_cap=cap,
                       pair_overflow=bool(out[2]))
        return out

    kx.boundary_extract, turbo._select_compact = extract_rec, select_rec
    try:
        flags = turbo.segment_turbo_flagged(image, cfg, GOSSIP_ROUNDS)[1]
    finally:
        kx.boundary_extract, turbo._select_compact = extract, select
    return flags, rec


def _sweep_rows(run, dev, card, unrecorded):
    """`bench.sweep` over one SWEEP_RUNS entry as one counted path, then
    each row: flags 0 and the oracle's partition (or, for
    SWEEP_MAY_OVERFLOW, FLAG_PAIR_OVERFLOW from the candidate pool alone),
    its warm-up call's launches against the record."""
    (h, w), wb, configs = SWEEP_RUNS[run]
    argv = ["--shapes", f"{h}x{w}", "--configs", ",".join(configs),
            "--reps", str(SWEEP_REPS), "--out", str(STEP14_OUT / "sweep.jsonl"),
            "--device", str(dev)] + (["--wb16"] if wb else [])
    rows, rec = _module_run(run, lambda: sweep.main(argv), card)
    by = {}
    for row in rows:
        path = _sweep_path(row["config"], h, w, wb)
        _step13_launches(path, row["launches"], unrecorded)
        if "error" in row:
            what = f"flags {row.get('flags')}, {row['error']}"
            if (row["config"], wb) not in SWEEP_MAY_OVERFLOW:
                raise AssertionError(f"{path}: {row['error']}")
            image = torch.from_numpy(sweep.image(h, w)).to(dev)
            with sweep.Knobs(sweep.CONFIGS[row["config"]]):
                flags, probe = _handoff_probe(image, sweep.config(wb))
                cap_live = turbo.capacities(h * w, wb)["cap_live"]
            del image
            row["handoff"] = probe
            what += f"; handoff {probe}"
            if (flags != turbo.FLAG_PAIR_OVERFLOW
                    or row["flags"] != turbo.FLAG_PAIR_OVERFLOW
                    or not probe["candidate_overflow"]
                    or probe["pair_overflow"]
                    or probe["cap_live"] != cap_live):
                raise AssertionError(f"{path}: not the candidate pool's "
                                     f"overflow alone: {what}")
        else:
            if row["flags"] or not row.get("oracle_equal"):
                raise AssertionError(f"{path}: {row}")
            what = (f"flags 0, the oracle's partition; warm-up "
                    f"{row['warm_s']:.3f} s; _timed median "
                    f"{row['median_ms']:.3f} ms (mean {row['mean_ms']:.3f}) "
                    f"of {row['reps']} reps = {row['mpix_per_s']:.2f} MPix/s")
        print(f"main path {path}: {what}; launches {row['launches']}, peak "
              f"memory {row.get('peak_mib', 0.0):.1f} MiB ({card})",
              flush=True)
        by[path] = row
    if run == "sweep_4k_wb0":
        base, nopad = (by[_sweep_path(c, h, w, wb)]
                       for c in ("baseline", "nofastpad"))
        if (base["labels_sha256"] != nopad["labels_sha256"]
                or any(nopad["launches"][n] for n in PADS)
                or not all(base["launches"][n] for n in PADS)):
            raise AssertionError(f"{run}: nofastpad {nopad}, baseline {base}")
        print(f"check {run}: nofastpad labels bit-equal to the padded "
              f"route's (sha256 {base['labels_sha256'][:16]}...), pad/unpad "
              f"launches {[nopad['launches'][n] for n in PADS]} against "
              f"{[base['launches'][n] for n in PADS]}; B/A of the medians "
              f"{nopad['median_ms'] / base['median_ms']:.4f} ({card})",
              flush=True)
    return {run: rec | {"rows": by}}


def _synthetic_quality(dev, card, unrecorded):
    """`bench.evidence`'s quality section (the synthetic set, 20 images),
    each algorithm counted as one path: every ASA and UE equal to
    `bench_out/quality.jsonl`, the overflow policy's atomic route
    counted."""
    with open(QUALITY_SET_RECORD) as f:
        record = {(r["image"], r["algorithm"]): r
                  for r in map(json.loads, f)}
    out, rows, bad = {}, [], []
    for name, extra in evidence.QUALITY_ALGOS:
        path = _synthetic_path(name)
        t0 = time.perf_counter()
        got, launches, _, _, reads, peak = _counted(
            path, lambda: evidence.section_quality(dev, 20, [(name, extra)]))
        seconds = time.perf_counter() - t0
        rows += got
        for r in got:
            ref = record[r["image"], name]
            if "error" in r or (r["asa"], r["ue"]) != (ref["asa"],
                                                       ref["ue"]):
                bad.append((name, r["image"]))
                print(f"  {path} {r['image']}: {r}, record {ref}",
                      flush=True)
        fell = sum(r.get("fallback", False) for r in got)
        ms = statistics.median(r["ms"] for r in got if "ms" in r)
        print(f"main path {path}: {len(got)} rows, {fell} by the overflow "
              f"policy's atomic route; launches {launches}, host reads "
              f"{reads}, peak memory {peak:.1f} MiB, {seconds:.1f} s, median "
              f"{ms:.3f} ms an image = {SYNTHETIC_PIXELS / 1e3 / ms:.2f} MPix/s "
              f"({card})", flush=True)
        out[path] = {"launches": launches, "host_reads": reads,
                     "peak_mib": peak, "seconds": seconds, "fallback": fell,
                     "median_ms_per_image": ms}
        _step13_launches(path, launches, unrecorded)
    with open(STEP14_OUT / "quality.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"check synthetic_quality: {len(rows) - len(bad)} of {len(rows)} "
          f"rows equal to {QUALITY_SET_RECORD.relative_to(ROOT)}", flush=True)
    if bad or len(rows) != len(record):
        raise AssertionError(f"synthetic_quality: rows {bad} differ")
    return out


def _new_ladder_rows(dev, card, unrecorded):
    """`bench.evidence`'s perf section over NEW_LADDERS as one counted path
    (every row flags 0 and its oracle's partition), then each row once
    more, counted."""
    rows, rec = _module_run(EVIDENCE_RUN, lambda: evidence.section_perf(
        str(STEP14_OUT), dev, STEP14_REPS, NEW_LADDERS), card)
    runs = {EVIDENCE_RUN: rec}
    for row in rows:
        name, h, w = row["algorithm"], row["height"], row["width"]
        path = _ladder_path(name, h, w, "blobs")
        if "error" in row or row["flags"] or row.get("oracle_equal") is not True:
            raise AssertionError(f"{path}: {row}")
        extra = dict(weight_buckets=16) if name == "turbo_wb16" else {}
        cfg = SegmentationConfig(k=300.0, min_size=100, **extra)
        image = torch.from_numpy(harness.ladder_image(h, w)).to(dev)
        labels, rec = _step13_row(path, lambda: harness.segment_fn(
            evidence.base_algo(name), cfg, device=dev)(image), card,
            unrecorded, h * w, reps=0)
        equal = evidence.oracle_equal(name, "blobs", h, w,
                                      labels.cpu().numpy())
        t = row["total"]
        rec |= {"flags": row["flags"], "oracle_equal": equal,
                "median_ms": t["median_s"] * 1e3, "reps": t["reps"],
                "mean_ms": t["mean_s"] * 1e3, "inner": t["inner"],
                "mpix_per_s": h * w / 1e6 / t["median_s"]}
        _row_line(path, rec, card, f"flags {row['flags']}, the oracle's "
                  f"partition {equal}")
        if not equal:
            raise AssertionError(f"{path}: partition differs from the "
                                 "oracle")
        runs[path] = rec
        del image, labels
    return runs


def _evidence_step(dev, card):
    """Step 14. Returns (path records, step record)."""
    t0 = time.perf_counter()
    gc.collect()
    STEP14_OUT.mkdir(parents=True, exist_ok=True)
    for f in STEP14_OUT.glob("*.jsonl"):
        f.unlink()
    unrecorded, step, runs = {}, {}, {}
    for run in SWEEP_RUNS:
        runs |= _sweep_rows(run, dev, card, unrecorded)
        step[f"{run}_s"] = time.perf_counter() - t0 - sum(step.values())
    runs |= _synthetic_quality(dev, card, unrecorded)
    step["synthetic_quality_s"] = (time.perf_counter() - t0
                                   - sum(step.values()))
    runs |= _new_ladder_rows(dev, card, unrecorded)
    step["new_ladder_rows_s"] = (time.perf_counter() - t0
                                 - sum(step.values()))
    for path in STEP14_RUNS:
        _step13_launches(path, runs[path]["launches"], unrecorded)
    print(summarize.summary(str(STEP14_OUT)), flush=True)
    step["seconds"] = time.perf_counter() - t0
    print(f"step 14 took {step['seconds']:.1f} s ({card})", flush=True)
    if unrecorded:
        print("unrecorded launches: " + json.dumps(unrecorded), flush=True)
        raise AssertionError(f"launches of paths with no record: "
                             f"{sorted(unrecorded)}")
    return runs, step


# per-kernel keys of the kernels line beyond the contract's, where measured
_EXTRA_KEYS = ("library_device_ms", "device_ms_rows", "device_ms_cols",
               "device_ms_fill", "device_ms_bulk", "device_ms_regs", "ms_regs",
               "device_ms_bulk_cold", "device_ms_ungated", "tile_share_call",
               "steps_per_tile_call", "pass_fit_ms", "pairs", "cap",
               "fill_bytes")
_KEYS_8K = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "max_abs_err")


# ---------------------------------------------------------------------------
# step 15: stage 2's two label spaces (models/turbo.py `_s2_stage`)
# ---------------------------------------------------------------------------

# the benchmark's four frames: (h, w, weight_buckets, content)
S2_FRAMES = {
    "speed_1080p": (1080, 1920, 0, "blobs"),
    "quality_1080p": (1080, 1920, 16, "blobs"),
    "speed_4k": (2160, 3840, 0, "blobs"),
    "speed_photos": (321, 481, 0, "bsds_like"),
}
# the hand-written round's launches (`ks2.s2_round.launches`, one a round)
# over one frame's stage 2 in root space, and over one frame of the
# hierarchy and fastmst paths (their rounds V-indexed). Run 24a recorded
# them under these names; the s2_graphs_* entries of runs 23g-23j before
# them counted three frames of the four benchmark frames (the graphs'
# eager, capturing and replaying frames).
RECORDED_LAUNCHES |= {f"s2_spaces_{name}": ("24a", dict(s2_round=n))
                      for name, n in {
    "speed_1080p": 10, "quality_1080p": 15, "speed_4k": 11,
    "speed_photos": 8, "turbo_hierarchy_1080p": 10, "fastmst_1080p": 13,
    "fastmst_4k": 14}.items()}


def _s2_frame(h, w, content, dev, seed=0):
    from gseg_tpu_torch.utils.synthetic import bsds_like_scene

    img = (blobs_image(h, w, max(8, h * w // 65536), 8.0, seed)
           if content == "blobs" else bsds_like_scene(h, w, 90, seed)[0])
    return torch.from_numpy(np.ascontiguousarray(img)).to(dev)


def _s2_counted(fn):
    """fn() with the tracing on: (result, counts: the rounds
    (`host_reads.s2_merged`) and the hand-written round's launches
    (`ks2.s2_round.launches`)), every round one launch and one span."""
    launches = ks2.s2_round.launches
    with _traced() as t:
        out = fn()
        torch.cuda.synchronize()
    spans = [sp for sp in t.rec.spans if sp.name == "gseg.s2_round"]
    counts = {"rounds": t.rec.counters.get("host_reads.s2_merged", 0),
              "launches": ks2.s2_round.launches - launches}
    if not counts["launches"] == counts["rounds"] == len(spans):
        raise AssertionError(f"s2 rounds: counts {counts}, {len(spans)} "
                             "spans")
    return out, counts


def _stage_peaks(image, cfg):
    """MiB allocated at the peak of each stage of one frame of
    segment_turbo_impl (the peak statistic reset as each stage starts),
    and the MiB allocated before the frame."""
    h, w = image.shape[:2]
    v = h * w
    base = _peak_reset() / 2**20
    peaks = {}

    def stage(name, fn):
        _peak_reset()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**20
        return out

    gst, wts, thr = stage("stage_g", lambda: turbo._stage_g(
        image, cfg, GOSSIP_ROUNDS))
    st, rm, r0 = stage("extract", lambda: turbo._extract_stage(gst, wts,
                                                               cfg))
    st2 = stage("stage2", lambda: turbo._s2_stage(st, v, cfg, thr, r0))
    stage("final_map", lambda: turbo._final_map(
        gst, st2, rm, r0, 4 * (h + w),
        closures=cfg.weight_buckets > 0 and turbo._Q_CLOSURES))
    return peaks, base


def _s2_space_check(name, image, cfg, card):
    """Stage 2 of one frame in both label spaces: V-indexed (no root
    list) and in root-index space. fin, the flags, the last phase's
    rounds and the final labels must be bit-equal; the root-space run's
    launches as recorded; then both timed in turns, and each stage's
    peak."""
    h, w = image.shape[:2]
    v = h * w
    gst, wts, thr = turbo._stage_g(image, cfg, GOSSIP_ROUNDS)
    st, rm, r0 = turbo._extract_stage(gst, wts, cfg)
    vidx = turbo._s2_stage(st, v, cfg, thr)
    root, c = _s2_counted(lambda: turbo._s2_stage(st, v, cfg, thr, r0))
    maps = [turbo._final_map(gst, s, rm, r0, 4 * (h + w))[0]
            for s in (vidx, root)]
    if not (torch.equal(root.fin, vidx.fin) and int(root.flags) ==
            int(vidx.flags) and root.it == vidx.it
            and root.SZf.numel() == r0.numel() < v
            and torch.equal(maps[0], maps[1])):
        raise AssertionError(f"s2 spaces {name}: the root-space stage 2 "
                             "differs from the V-indexed one")
    _s2_recorded_launches(f"s2_spaces_{name}", c["launches"])
    root_ms, vidx_ms = _turns_ms([
        lambda: turbo._s2_stage(st, v, cfg, thr, r0),
        lambda: turbo._s2_stage(st, v, cfg, thr)], 7)
    peaks, base = _stage_peaks(image, cfg)
    rec = {"flags": int(vidx.flags), "roots": r0.numel(),
           "stage2_ms": {"root_space": root_ms, "v_indexed": vidx_ms},
           "stage_peak_mib": peaks, "allocated_before_mib": base} | c
    print(f"check s2 spaces {name}: fin, flags ({rec['flags']}) and final "
          f"labels bit-equal root space ({r0.numel()} slots) / V-indexed; "
          f"{c['rounds']} rounds, s2_round launches {c['launches']}; stage "
          f"2 ms root space {root_ms:.3f}, V-indexed {vidx_ms:.3f}; stage "
          f"peaks MiB {_round(peaks)}, allocated before {base:.2f} "
          f"({card})", flush=True)
    return rec


def _round(d):
    return {k: round(x, 2) for k, x in d.items()}


@contextlib.contextmanager
def _v_indexed():
    """Stage 2 without the root list (its rounds V-indexed) for the
    block."""
    was = turbo._s2_stage
    turbo._s2_stage = lambda st, v, cfg, thr=None, r0=None, rec_cap=0: was(
        st, v, cfg, thr, None, rec_cap)
    try:
        yield
    finally:
        turbo._s2_stage = was


def _s2_recorded_launches(path, launches):
    """The hand-written round's launches against their record, where one
    is kept."""
    if path in RECORDED_LAUNCHES:
        run, recorded = RECORDED_LAUNCHES[path]
        if launches != recorded["s2_round"]:
            raise AssertionError(f"{path}: s2_round launches {launches}, "
                                 f"run {run}'s {recorded['s2_round']}")


def _s2_v_indexed_path(name, run):
    """A path whose rounds run V-indexed (no root list): its launches as
    recorded, flags 0, and a second run's output equal to the first."""
    out, c = _s2_counted(run)
    _s2_recorded_launches(f"s2_spaces_{name}", c["launches"])
    again = run()
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(out, again))
    print(f"check s2 spaces {name}: flags {out[-1]}, a second run equal "
          f"{same}, counts {c}", flush=True)
    if not same or out[-1]:
        raise AssertionError(f"s2 spaces {name}: flags {out[-1]}, second "
                             f"run equal {same}")
    return {"equal": same} | c


def _s2_spaces_step(dev, card):
    """Step 15: returns (runs, step record)."""
    t0 = time.perf_counter()
    rows = {}
    for name, (h, w, wb, content) in S2_FRAMES.items():
        cfg = dataclasses.replace(CFG, weight_buckets=wb)
        rows[name] = _s2_space_check(name, _s2_frame(h, w, content, dev),
                                     cfg, card)
    img1080 = _s2_frame(1080, 1920, "blobs", dev)
    img540 = _s2_frame(540, 960, "blobs", dev)
    mesh = spatial.spatial_mesh(["cuda:0"] * 4)

    def spatial_run():
        return turbo_spatial.segment_turbo_spatial(img540, CFG, mesh)

    # the ranks pass their root lists: their rounds run in root space
    (lab, fl), c = _s2_counted(spatial_run)
    with _v_indexed():
        lab_v, fl_v = spatial_run()
    dense, dfl = turbo.segment_turbo_flagged(img540, CFG, GOSSIP_ROUNDS)
    if fl or fl_v or not (torch.equal(lab, lab_v)
                          and torch.equal(lab, dense)):
        raise AssertionError(f"s2 spaces spatial: rows differ ({c})")
    root_ms, vidx_ms = _turns_ms([
        lambda: spatial_run(),
        lambda: _in_v_indexed(spatial_run)], 5)
    print(f"check s2 spaces spatial_540p_4ranks: flags {fl}, labels equal "
          f"V-indexed and dense; counts {c}; ms a call root space "
          f"{root_ms:.3f}, V-indexed {vidx_ms:.3f} ({card})", flush=True)
    # the ranks running free
    rows["spatial_540p_4ranks"] = {
        "equal": True, "ms_root_space": root_ms, "ms_v_indexed": vidx_ms,
        "turns_free_ms": _turns_ab("s2 spaces spatial_540p_4ranks",
                                   spatial_run, card, pairs=1)} | c
    rows["turbo_hierarchy_1080p"] = _s2_v_indexed_path(
        "turbo_hierarchy_1080p",
        lambda: turbo.segment_turbo_hierarchy_flagged(img1080, CFG,
                                                      GOSSIP_ROUNDS))
    rows["fastmst_1080p"] = _s2_v_indexed_path(
        "fastmst_1080p", lambda: fastmst.segment_fastmst_flagged(img1080,
                                                                 CFG))
    img4k = _s2_frame(2160, 3840, "blobs", dev)
    rows["fastmst_4k"] = _s2_v_indexed_path(
        "fastmst_4k", lambda: fastmst.segment_fastmst_flagged(img4k, CFG))
    step = {"seconds": time.perf_counter() - t0}
    print(f"step 15 took {step['seconds']:.1f} s", flush=True)
    return {f"s2_spaces_{k}": v for k, v in rows.items()}, step


def _in_v_indexed(fn):
    with _v_indexed():
        return fn()


# stage 2's hand-written round in each path's counted run (runs 23f, 23g
# and 23h): one launch a round; the other paths run none. The sweep rows
# whose candidate pool overflows (SWEEP_MAY_OVERFLOW) hold no count:
# which candidates land in the pool follows the order of the extraction's
# atomics, and so do their rounds (14 and 13 at gate 13 in runs 23h and
# 23i); they must launch it.
S2_LAUNCHES = {
    "1080p_batch4": 40, "1080p_cli": 10, "1080p_cli_level4": 10,
    "1080p_count": 10, "1080p_fastmst": 13, "1080p_fastmst_hierarchy": 13,
    "1080p_final_gather": 10, "1080p_flood_ptr": 10, "1080p_late_closures": 10,
    "1080p_runs": 10, "1080p_spatial4": 40, "1080p_spatial4_final_gather": 40,
    "1080p_spatial4_wb16": 60, "1080p_subsum": 10, "1080p_turbo_hierarchy": 10,
    "1080p_turbo_hierarchy_final_gather": 10, "1080p_wb16": 15,
    "1080p_wb16_closures": 15, "1080p_wb16_closures_tscan4": 15,
    "1080p_wb16_no_q_closures": 15, "1080p_wb16_rlist_nosplit": 15,
    "4k_batch2": 22, "4k_fastmst": 14, "4k_final_gather": 11,
    "4k_flood_ptr": 11, "4k_spatial4": 44, "4k_subsum": 11, "4k_t16": 11,
    "4k_wb16": 15, "bsds_like_quality_fastmst": 231,
    "bsds_like_quality_turbo": 171, "bsds_like_quality_turbo_wb16": 139,
    "ladder_fastmst_1080x1920": 13, "ladder_fastmst_1440x2560": 14,
    "ladder_fastmst_2160x3840": 14, "ladder_fastmst_2880x5120": 14,
    "ladder_fastmst_4320x7680": 14, "ladder_fastmst_540x960": 12,
    "ladder_fastmst_720x1280": 12, "ladder_turbo_1080x1920": 10,
    "ladder_turbo_1440x2560": 11, "ladder_turbo_2160x3840": 11,
    "ladder_turbo_2880x5120": 11, "ladder_turbo_4320x7680": 11,
    "ladder_turbo_540x960": 9, "ladder_turbo_720x1280": 9,
    "ladder_turbo_textured_1080x1920": 8,
    "ladder_turbo_textured_2160x3840": 10, "ladder_turbo_textured_540x960": 7,
    "ladder_turbo_wb16_540x960": 13, "parity_1080p_textured_k10_wb16": 10,
    "parity_540p_blobs": 9, "parity_540p_textured": 7,
    "parity_synthetic000": 8, "parity_synthetic001": 8,
    "parity_synthetic002": 8, "parity_synthetic003": 8,
    "parity_synthetic004": 7, "parity_synthetic005": 6,
    "parity_synthetic006": 9, "parity_synthetic007": 6,
    "parity_synthetic008": 9, "parity_synthetic009": 8,
    "parity_synthetic010": 7, "parity_synthetic011": 8,
    "parity_synthetic012": 8, "parity_synthetic013": 10,
    "parity_synthetic014": 10, "parity_synthetic015": 6,
    "parity_synthetic016": 7, "parity_synthetic017": 7,
    "parity_synthetic018": 7, "parity_synthetic019": 8,
    "spatial8_short_tiles": 48, "spatial_parity_blobs_540x960_4ranks_wb0": 36,
    "spatial_parity_blobs_540x960_4ranks_wb16": 52,
    "spatial_parity_blobs_720x1280_8ranks_wb0": 72,
    "spatial_parity_blobs_720x1280_8ranks_wb16": 104,
    "spatial_parity_dense_blobs_540x960_wb0": 9,
    "spatial_parity_dense_blobs_540x960_wb16": 13,
    "spatial_parity_dense_blobs_720x1280_wb0": 9,
    "spatial_parity_dense_blobs_720x1280_wb16": 13,
    "spatial_parity_dense_textured_540x960_wb0": 7,
    "spatial_parity_dense_textured_540x960_wb16": 10,
    "spatial_parity_dense_textured_720x1280_wb0": 8,
    "spatial_parity_dense_textured_720x1280_wb16": 8,
    "spatial_parity_textured_540x960_4ranks_wb0": 28,
    "spatial_parity_textured_540x960_4ranks_wb16": 40,
    "spatial_parity_textured_720x1280_8ranks_wb0": 64,
    "spatial_parity_textured_720x1280_8ranks_wb16": 64,
    "sweep_baseline_1080x1920_wb0": 10, "sweep_baseline_1080x1920_wb16": 15,
    "sweep_baseline_2160x3840_wb0": 11, "sweep_closures_1080x1920_wb0": 10,
    "sweep_finalgather_1080x1920_wb0": 10, "sweep_floodptr_1080x1920_wb0": 10,
    "sweep_floodptr_fg_1080x1920_wb0": 10, "sweep_gate32_1080x1920_wb0": 11,
    "sweep_gateq16_1080x1920_wb16": 16, "sweep_nofastpad_1080x1920_wb0": 10,
    "sweep_nofastpad_2160x3840_wb0": 11, "sweep_nosmall_1080x1920_wb0": 10,
    "sweep_peelcount_1080x1920_wb0": 10,
    "sweep_qnoclosures_1080x1920_wb16": 15, "synthetic_quality_fastmst": 228,
    "synthetic_quality_turbo": 155, "synthetic_quality_turbo_wb16": 174}
S2_UNSETTLED = {_sweep_path(c, 1080, 1920, wb)
                for c, wb in SWEEP_MAY_OVERFLOW}
for _path, _n in S2_LAUNCHES.items():
    _run, _rec = RECORDED_LAUNCHES[_path]
    RECORDED_LAUNCHES[_path] = (f"{_run}, 23f-23h", _rec | {S2: _n})

# the join of the chunk fronts in each path's counted run: one launch a
# call of `turbo._chunked_pair_extract`, so one a DPP frame (fastmst, its
# hierarchy, superpixel and its hierarchy; the quality protocols' 20
# images) and one a rank and frame on the row-sharded turbo path; the
# other paths run none. The whole-module runs of steps 13 and 14 follow
# from their rows.
PAIR_JOIN_LAUNCHES = {
    "1080p_fastmst": 1, "4k_fastmst": 1, "1080p_fastmst_hierarchy": 1,
    "1080p_superpixel": 1, "1080p_superpixel_hierarchy": 1,
    "1080p_spatial4": 4, "1080p_spatial4_wb16": 4, "4k_spatial4": 4,
    "spatial8_short_tiles": 8, "1080p_spatial4_final_gather": 4,
    "bsds_like_quality_fastmst": 20, "bsds_like_quality_superpixel": 20,
    "synthetic_quality_fastmst": 20, "synthetic_quality_superpixel": 20,
    "ladder_superpixel_540x960": 1, "ladder_superpixel_720x1280": 1,
    "ladder_superpixel_1080x1920": 1}
PAIR_JOIN_LAUNCHES |= {p: 1 for p in LADDER_DPP} | {
    f"ladder_fastmst_{r}": 1 for r in ("2880x5120", "4320x7680")}
PAIR_JOIN_LAUNCHES |= {
    f"spatial_parity_{c}_{r}_wb{b}": n for c in ("blobs", "textured")
    for r, n in (("540x960_4ranks", 4), ("720x1280_8ranks", 8))
    for b in (0, 16)}
for _path, _n in PAIR_JOIN_LAUNCHES.items():
    _run, _rec = RECORDED_LAUNCHES[_path]
    RECORDED_LAUNCHES[_path] = (f"{_run}, 25", _rec | {PJ: _n})


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
    if sys.argv[1:] == ["--cards"]:
        print("cards: " + json.dumps(_cross_card(card)))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--parity"]:
        runs, step = _parity_step(dev, card)
        print("parity: " + json.dumps(
            {p: {k: v for k, v in r.items() if k != "launches"}
             for p, r in runs.items()} | {"step": step}, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--evidence"]:
        runs, step = _evidence_step(dev, card)
        print("evidence: " + json.dumps(
            {p: {k: v for k, v in r.items() if k != "launches"}
             for p, r in runs.items()} | {"step": step}, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--s2-spaces"]:
        runs, step = _s2_spaces_step(dev, card)
        print("s2 spaces: " + json.dumps(runs | {"step": step}, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--alternatives"]:
        images = {(h, w): torch.from_numpy(blobs_image(h, w, n, 8.0, 0)).to(
            dev) for h, w, n in ((1080, 1920, 31), (2160, 3840, 126))}
        errs = {name: 0.0 for name in KERNELS}
        runs, step = _alternatives(images, card, errs)
        print("alternatives: " + json.dumps(
            {"paths": runs, "step": step,
             "max_abs_err": {n: errs[n] for n in STEP}}, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    errs = _random_checks(dev)
    errs["run_extract"] = max(errs["run_extract"], _runs_checks(dev))
    for name, err in _serpentine_check(dev, card).items():
        errs[name] = max(errs[name], err)
    pad_errs, timed8k = _pad_checks(dev, card)
    for name, err in pad_errs.items():
        errs[name] = max(errs[name], err)
    print(f"random and serpentine checks done at "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    images, timed, runs, runs_planes = {}, {}, {}, {}
    warm = kg.WARM_PASSES
    for path, P in PATHS.items():
        if (P.h, P.w) not in images:
            images[P.h, P.w] = torch.from_numpy(
                blobs_image(P.h, P.w, P.blobs, 8.0, 0)).to(dev)
        image = images[P.h, P.w]
        turbo._PEEL_SIZES = P.sizes
        kg.WARM_PASSES = warm if P.warm_passes is None else P.warm_passes
        try:
            # every kernel at the fields this path gives it; each kernel
            # is timed on one path.
            fields = _capture_main_path_fields(image, _cfg(path))
            missing = {n for n in KERNELS if path in KERNELS[n].must
                       and n not in CLOSURES} - set(fields)
            if missing:
                raise AssertionError(f"{path} never called {sorted(missing)}")
            if path in ("1080p_subsum", "4k_subsum"):
                to_time = dict(fields)
            elif path == "1080p_wb16_closures":
                to_time = {c: (fields[f][0][:-1], {})
                           for c, f in CLOSURE_OF.items()}
            elif path == "4k_wb16":
                to_time = _padded_closure_fields(fields)
            else:
                to_time = {}
            for name in [n for n in STEP if n in fields]:
                args, kwargs = fields[name]
                n, err = _gated_passes(name, args, kwargs)
                errs[name] = max(errs[name], err)
                print(f"check {name} {path} main-path fields "
                      f"{sorted(kwargs)} gated passes: {n} passes equal to "
                      "step_pass_plain", flush=True)
            for name, (args, kwargs) in fields.items():
                if name in to_time:
                    continue
                errs[name] = max(errs[name], _compare(name, args, kwargs))
                print(f"check {name} {path} main-path fields "
                      f"{kwargs or ''}: equal to plain", flush=True)
            if path == "4k_wb16":
                _closure_route_check(fields, path, errs)
            timed[path] = _time_kernels(
                to_time, f"{path} main-path fields", card,
                plain_reps=3 if path in ("1080p_subsum",) else 1)
            if path in ("1080p_runs", "4k_subsum"):
                # run_extract on each peel round's label plane: the runs
                # path's calls, and the 4K default path's round labels
                # (the same planes the runs peel would give it at 4K)
                planes = ([a[0] for a in _record_calls(
                    image, _cfg(path), "run_extract")] if path == "1080p_runs"
                    else _record_calls(image, _cfg(path), "gossip_labeldist",
                                       outputs=True))
                for i, L in enumerate(planes):
                    cap = max(L.numel() // 2, 1024)
                    rec = _time_kernels(
                        {"run_extract": ((L, cap), {})},
                        f"{path} peel round {i + 1} label plane", card, 1)
                    rec = runs_planes[f"{path}_round{i + 1}"] = rec[
                        "run_extract"]
                    errs["run_extract"] = max(errs["run_extract"],
                                              rec["max_abs_err"])
                if path == "1080p_runs":
                    timed[path]["run_extract"] = runs_planes[
                        "1080p_runs_round1"]
            for name, rec in timed[path].items():
                errs[name] = max(errs[name], rec["max_abs_err"])
            runs[path] = _run_path(path, image, card)
            runs[path] |= _step_ab(path, image, card)
        finally:
            kg.WARM_PASSES = warm
            turbo._PEEL_SIZES = "subsum"
        print(f"path {path} done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    P = PATHS["1080p_subsum"]
    ab = _peel_ab(images[P.h, P.w], card)
    runs |= _new_paths(images, card)
    print(f"new paths done at {time.perf_counter() - t0:.1f} s", flush=True)
    dpp, dpp_timed = _dpp_paths(images, card)
    runs |= dpp
    timed |= dpp_timed
    for path, name in (("1080p_superpixel", "ordered_scatter_add"),
                       ("4k_fastmst", S2), ("4k_fastmst", PJ)):
        errs[name] = max(errs[name], timed[path][name]["max_abs_err"])
    print(f"DPP paths done at {time.perf_counter() - t0:.1f} s", flush=True)
    runs |= _cli_paths(images[1080, 1920], card)
    print(f"CLI paths done at {time.perf_counter() - t0:.1f} s", flush=True)
    runs |= _bsds_quality(dev, card, errs)
    print(f"bsds_like_quality done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    parallel, slab = _parallel_paths(images, card, errs)
    runs |= parallel
    print(f"parallel paths done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    ladder, timed["1440p"], perf_half = _perf_half(card, errs)
    runs |= ladder
    print(f"performance half done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    alt_runs, alternatives = _alternatives(images, card, errs)
    runs |= alt_runs
    print(f"alternatives done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    parity_runs, parity_step = _parity_step(dev, card)
    runs |= parity_runs
    print(f"parity protocol done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    evidence_runs, evidence_step = _evidence_step(dev, card)
    runs |= evidence_runs
    print(f"evidence campaign done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    s2_runs, s2_step = _s2_spaces_step(dev, card)
    print(f"stage 2 label spaces done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    if "jax" in sys.modules or any(m.startswith("gseg_tpu.")
                                   for m in sys.modules):
        raise AssertionError("the port imported jax or gseg_tpu")
    timed_on = ({n: "4k_subsum" for n in PADS}
                | {n: "1080p_wb16_closures" for n in CLOSURES}
                | {"run_extract": "1080p_runs",
                   "ordered_scatter_add": "1080p_superpixel",
                   PJ: "4k_fastmst"})
    kernels = []
    shares = {}
    for name in STEP:
        by = [r["active_by_kernel"][name] for r in runs.values()
              if name in r.get("active_by_kernel", {})]
        shares[name] = (sum(b["computed_first_full"] for b in by)
                        / sum(b["launched"] for b in by))
    for name in KERNELS:
        rec = timed[timed_on.get(name, "1080p_subsum")][name]
        rec4k = (runs_planes["4k_subsum_round1"] if name == "run_extract"
                 else timed["4k_wb16" if name in CLOSURES
                            else "4k_subsum"].get(name, {}))
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name].source,
            "replaces": KERNELS[name].replaces,
            "launches": sum(r["launches"][name] for r in runs.values()),
            "launches_by_path": {p: r["launches"][name]
                                 for p, r in runs.items()},
            "max_abs_err": errs[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "timed_on": timed_on.get(name, "1080p_subsum"),
            "passes_per_call": rec["passes"], "device_ms": rec["device_ms"],
            "ms_4k": rec4k.get("ms"), "device_ms_4k": rec4k.get("device_ms"),
            "plain_ms_4k": rec4k.get("plain_ms"),
            "bound_ms_4k": rec4k.get("bound_ms")}
            | {k: rec[k] for k in _EXTRA_KEYS if k in rec}
            | {f"{k}_4k": rec4k[k] for k in _EXTRA_KEYS if k in rec4k}
            | {f"{k}_1440p": v for k, v in timed["1440p"].get(name, {}).items()
               if k in _EXTRA_KEYS + _KEYS_8K}
            | ({"active_tile_share": shares[name],
                "steps_per_pass": alternatives["steps_per_pass"][name]}
               if name in STEP else {})
            | ({"slab_route": slab[name]} if name in slab else {})
            | ({"label_planes": {p: {k: r[k] for k in _KEYS_8K + (
                "library_device_ms", "bound_by", "device_ms_rows",
                "device_ms_fill", "pairs", "cap", "fill_bytes")}
                for p, r in runs_planes.items()}}
               if name == "run_extract" else {})
            | {f"{k}_8k": v for k, v in timed8k.get(name, {}).items()
               if k in _EXTRA_KEYS + _KEYS_8K}
            | {f"{k}_fastmst_4k": v for k, v in timed["4k_fastmst"].get(
                name, {}).items() if k in _KEYS_8K})
    print("paths: " + json.dumps(
        {p: {k: v for k, v in r.items() if k != "launches"}
         for p, r in runs.items()} | {"peel_ab_1080p": ab,
                                       "perf_half": perf_half,
                                       "alternatives": alternatives,
                                       "parity": parity_step,
                                       "evidence": evidence_step,
                                       "s2_spaces": s2_runs | {
                                           "step": s2_step}},
        default=str))
    print(f"chip_smoke wall time {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
