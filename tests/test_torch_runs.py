"""PyTorch port's row-run extraction and the `runs` peel vs references.

- A NumPy mirror of the CUDA kernel's decomposition (tiles, per-thread
  pixels, warp scans of run heads and tail counts, the carry across
  tiles, one slot claim per block and tile, the fill past the count)
  against `run_extract_plain`, slot for slot, at every cap.
- `run_extract_plain` against an independent NumPy run scan (the pool as a
  sorted multiset, the exact count, the overflow flag) and against the
  reference's `run_extract` in Mosaic's TPU interpret mode (sums by label
  and overflow: the reference's count is an upper bound, the port's is
  exact).
- `_runs_sizes` on both of its branches (the run pool, and the counting
  scatter when the pool overflows) against the counting scatter.
- The `runs` peel end to end (`turbo._PEEL_SIZES = "runs"`) against the
  reference's Pallas path with `GSEG_PEEL_SIZES=runs` in interpret mode:
  labels byte-equal, flags equal, partition equal to the oracle. The CUDA
  kernel runs on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu.ops.pallas.extract import run_extract as ref_run_extract  # noqa: E402,E501
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops.kernels import runs as kr  # noqa: E402
from gseg_tpu_torch.utils.labels import canonical_min_labels_np  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

INT32_MAX = kr.INT32_MAX


def _np_runs(L):
    """(label, length) of every maximal same-label run of every row."""
    out = []
    for row in L:
        start = 0
        for x in range(1, len(row) + 1):
            if x == len(row) or row[x] != row[start]:
                out.append((int(row[start]), x - start))
                start = x
    return sorted(out)


def _pool(res):
    lab, cnt, count, ovf = res
    n = int(count)
    live = lab.numpy() != INT32_MAX
    assert int(live.sum()) == min(n, lab.numel())
    assert (cnt.numpy()[~live] == 0).all()
    return sorted(zip(lab.numpy()[live].tolist(), cnt.numpy()[live].tolist())), \
        n, bool(ovf)


@pytest.mark.parametrize("shape", [(23, 70), (1, 37), (37, 1), (40, 128)])
@pytest.mark.parametrize("ncomp", [1, 3, 50])
def test_run_extract_plain_matches_numpy(shape, ncomp):
    h, w = shape
    rng = np.random.default_rng(h * 7 + w + ncomp)
    L = rng.integers(0, ncomp, (h, w)).astype(np.int32)
    want = _np_runs(L)
    pairs, n, ovf = _pool(kr.run_extract(torch.from_numpy(L), h * w))
    assert pairs == want and n == len(want) and not ovf
    # a capacity below the count keeps the count exact and flags overflow.
    cap = max(len(want) // 2, 1) if len(want) > 1 else 0
    pairs, n, ovf = _pool(kr.run_extract(torch.from_numpy(L), cap))
    assert n == len(want) and ovf and len(pairs) == cap
    assert kr.run_extract.launches == 0


def test_run_extract_checks_its_input():
    with pytest.raises(ValueError, match="int32"):
        kr.run_extract(torch.zeros((4, 4), dtype=torch.int64), 16)


def _sums(lab, cnt):
    lab, cnt = np.asarray(lab), np.asarray(cnt)
    live = lab != INT32_MAX
    return {int(k): int(cnt[live][lab[live] == k].sum())
            for k in np.unique(lab[live])}


def test_run_extract_and_runs_sizes_match_reference(monkeypatch):
    """The pool summed by label equals the reference's (and the exact
    pixel counts), overflow agrees at a capacity far from the reference's
    window granularity; `_runs_sizes` equals the counting scatter on both
    branches, the reference's `_runs_sizes` included."""
    rng = np.random.default_rng(4)
    h, w = 40, 64
    L = rng.integers(0, 6, (h, w)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        r_lab, r_cnt, _, r_ovf = ref_run_extract(jnp.asarray(L), 1 << 14)
    lab, cnt, count, ovf = kr.run_extract(torch.from_numpy(L), 1 << 14)
    assert not bool(r_ovf) and not bool(ovf)
    want = {int(v): int((L == v).sum()) for v in np.unique(L)}
    assert _sums(r_lab, r_cnt) == _sums(lab, cnt) == want
    assert int(count) == len(_np_runs(L))
    assert bool(kr.run_extract(torch.from_numpy(L), 128)[3])

    # _runs_sizes: by runs (an oracle partition, few runs), then the
    # identity labeling (h * w runs > the 1024-pair floor: the scatter).
    img = blobs_image(h, w, 6, 6.0, 3)
    cfg = RefConfig(k=100.0, min_size=8)
    Lp = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    runs = int((Lp[:, 1:] != Lp[:, :-1]).sum()) + h
    assert runs <= 1024 < h * w
    Lid = np.arange(h * w, dtype=np.int32).reshape(h, w)
    monkeypatch.setattr(ref_turbo, "_use_pallas", lambda: True)
    for Lx in (Lp, Lid):
        with pltpu.force_tpu_interpret_mode():
            S_ref, _ = ref_turbo._runs_sizes(jnp.asarray(Lx))
        S, ovf = turbo._runs_sizes(torch.from_numpy(Lx))
        assert ovf is False
        assert np.array_equal(np.asarray(S_ref), S.numpy())
        assert np.array_equal(turbo._component_sizes(
            torch.from_numpy(Lx))[0].numpy(), S.numpy())


def test_runs_peel_matches_pallas_path(monkeypatch):
    """The reference's test_peel_runs_sizes_matches_oracle case, both
    packages in the runs peel."""
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(24, 40, 5, 6.0, 7)
    monkeypatch.setenv("GSEG_PEEL_SIZES", "runs")
    monkeypatch.setattr(ref_turbo, "_use_pallas", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        ref_labels, ref_flags = ref_turbo.segment_turbo_impl(
            jnp.asarray(img), RefConfig(**dataclasses.asdict(cfg)), 4)
    monkeypatch.setattr(turbo, "_PEEL_SIZES", "runs")
    labels, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg, 4)
    assert flags == int(ref_flags) == 0
    assert np.array_equal(np.asarray(ref_labels), labels.numpy())
    oracle = canonical_min_labels_np(segment_boruvka_np(
        img, RefConfig(**dataclasses.asdict(cfg))))
    assert np.array_equal(oracle, labels.numpy())


@pytest.mark.parametrize("seed", [0, 5])
def test_runs_peel_matches_default_peel(monkeypatch, seed):
    """The three peels give the same labels and flags on the CPU."""
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = torch.from_numpy(blobs_image(48, 56, 6, 6.0, seed))
    outs = {}
    for sizes in ("subsum", "count", "runs"):
        monkeypatch.setattr(turbo, "_PEEL_SIZES", sizes)
        labels, flags = turbo.segment_turbo_impl(img, cfg, 2)
        outs[sizes] = (labels.numpy(), flags)
    assert outs["runs"][1] == outs["subsum"][1] == outs["count"][1] == 0
    assert np.array_equal(outs["runs"][0], outs["subsum"][0])
    assert np.array_equal(outs["runs"][0], outs["count"][0])


def _kernel_mirror(L, cap, threads, k, lanes):
    """The decomposition of csrc/runs.cu in NumPy, at a small block: one
    block per row in row order, tiles of threads * k pixels, k consecutive
    pixels per thread, warps of `lanes` threads. Per tile: each thread's
    head and tail bits and last head; inclusive warp scans (max of the last
    heads, sum of the tails), the warps' totals combined across the block;
    the carry of the previous tiles' last head; the block's slots claimed
    at once (blocks claim in row order here); pairs staged in row order and
    written below cap. Returns the pool, the count and overflow, and the
    sentinel fill past the count."""
    h, w = L.shape
    tile = threads * k
    lab = np.full(cap, -7, np.int64)  # -7: never written
    cnt = np.full(cap, -7, np.int64)
    count = 0
    for y in range(h):
        row = L[y]
        carry = 0
        for x0 in range(0, w, tile):
            last_head, ntails, staged = [], [], []
            heads, tails = [], []
            for t in range(threads):
                x = x0 + k * t
                hb, tb = [], []
                for i in range(k):
                    p = x + i
                    hb.append(p < w and (p == 0 or row[p] != row[p - 1]))
                    tb.append(p < w and (p + 1 == w or row[p] != row[p + 1]))
                heads.append(hb)
                tails.append(tb)
                last_head.append(max([x + i for i in range(k) if hb[i]],
                                     default=-1))
                ntails.append(sum(tb))
            # inclusive scans inside each warp, then across the warps
            incl_h, incl_n = list(last_head), list(ntails)
            for t in range(threads):
                if t % lanes:
                    incl_h[t] = max(incl_h[t], incl_h[t - 1])
                    incl_n[t] += incl_n[t - 1]
            warp_h = [incl_h[min(s + lanes, threads) - 1]
                      for s in range(0, threads, lanes)]
            warp_n = [incl_n[min(s + lanes, threads) - 1]
                      for s in range(0, threads, lanes)]
            total = sum(warp_n)
            base, count = count, count + total
            for t in range(threads):
                wp, lane = divmod(t, lanes)
                before = incl_h[t - 1] if lane else -1
                before = max([before] + warp_h[:wp])
                off = incl_n[t] - ntails[t] + sum(warp_n[:wp])
                run_head = max(carry, before)
                for i in range(k):
                    if heads[t][i]:
                        run_head = x0 + k * t + i
                    if tails[t][i]:
                        staged.append((off, row[x0 + k * t + i],
                                       x0 + k * t + i - run_head + 1))
                        off += 1
            carry = max([carry] + warp_h)
            assert sorted(o for o, _, _ in staged) == list(range(total))
            for off, label, length in staged:
                if base + off < cap:
                    lab[base + off], cnt[base + off] = label, length
    lab[count:] = INT32_MAX  # the fill: only past the count
    cnt[count:] = 0
    return lab, cnt, count, count > cap


@pytest.mark.parametrize("w", [1, 5, 12, 13, 40])
@pytest.mark.parametrize("kind", ["equal", "alternating", "random"])
def test_kernel_decomposition_equals_plain(w, kind):
    """The mirror of the kernel's tiles, warp scans and carries gives the
    plain version's pool slot for slot (blocks claiming in row order place
    pairs in row-major tail order, as the plain version does), at every
    cap; tiles of 12 pixels (3 threads x 4 or 6 x 2, warps of 2 lanes)
    make runs cross threads, warps and tiles."""
    h = 4
    if kind == "equal":
        L = np.full((h, w), 3, np.int32)
    elif kind == "alternating":
        L = (np.arange(h * w).reshape(h, w) % 2).astype(np.int32)
    else:
        L = np.random.default_rng(w).integers(0, 2, (h, w)).astype(np.int32)
        L[1] = 9  # a row of one run
    n = len(_np_runs(L))
    for cap in sorted({0, 1, max(n - 1, 0), n, h * w}):
        want = [x.numpy() for x in kr.run_extract_plain(torch.from_numpy(L),
                                                        cap)]
        for threads, k, lanes in ((3, 4, 2), (6, 2, 2)):
            lab, cnt, count, ovf = _kernel_mirror(L, cap, threads, k, lanes)
            assert count == int(want[2]) == n and ovf == bool(want[3])
            assert np.array_equal(lab, want[0])
            assert np.array_equal(cnt, want[1])
