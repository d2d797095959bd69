"""The join of the chunk fronts (`ops/kernels/pairjoin.py`) on the CPU.

The wrapper's argument checks (dtype, shape, device, the kernel's chunk
limit and the pair cap) raise on every device; a CPU call runs the plain
version and launches nothing. The plain version is byte-equal to the
output-space scan it replaces (kept here as ops: a scatter of each chunk's
offset and a running maximum), and a NumPy mirror of `csrc/pairjoin.cu`'s
blocks (its block scan of the counts into int32 offsets, per slot a binary
search over the clamped offsets) is byte-equal to the plain version, at
chunk counts below, at and past one block's 256 threads. The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops.kernels import pairjoin as kpj  # noqa: E402
from gseg_tpu_torch.utils import timing  # noqa: E402

THREADS, ITEMS = 256, 8   # csrc/pairjoin.cu


def _inputs(nch, chunk, seed, dead_share=0.3, empty=()):
    """A join's inputs as the dedup hands them over: per chunk a count of
    heads and a permutation of the chunk (heads first), and the slots."""
    rng = np.random.default_rng(seed)
    n = nch * chunk
    counts = rng.binomial(chunk, 1.0 - dead_share, nch).astype(np.int64)
    counts[list(empty)] = 0
    perm = np.stack([rng.permutation(chunk) for _ in range(nch)])
    lo = rng.integers(0, 1 << 20, n).astype(np.int32)
    hi = rng.integers(0, 1 << 20, n).astype(np.int32)
    w = rng.uniform(0, 9, n).astype(np.float32)
    w[rng.random(n) < 0.1] = np.inf
    eid = rng.permutation(n).astype(np.int32)
    return [torch.from_numpy(x) for x in (counts, perm, lo, hi, w, eid)]


def _scan_join(counts, perm, lo, hi, w4, eid4, pair_cap):
    """The output-space scan of the ops the kernel replaced."""
    nch, chunk = perm.shape
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    marks = turbo._scatter(torch.zeros(pair_cap, dtype=torch.int64),
                           offsets.clamp(0, pair_cap - 1),
                           torch.arange(nch), "amax")
    chunk_of = torch.cummax(marks, 0).values
    j = torch.arange(pair_cap)
    src = (chunk_of * chunk + j - offsets[chunk_of]).clamp(0, nch * chunk - 1)
    src = (perm + torch.arange(nch)[:, None] * chunk).reshape(-1)[src]
    return (j < total), lo[src], hi[src], w4[src], eid4[src], total > pair_cap


def _kernel_mirror(counts, perm, lo, hi, w4, eid4, pair_cap):
    """csrc/pairjoin.cu block by block in NumPy: each block's scan of the
    counts (a run of `per` counts a thread, the threads' sums scanned),
    int32 offsets, then per slot the binary search and the gathers."""
    c, p = counts.numpy(), perm.numpy().reshape(-1)
    words = [x.numpy().view(np.uint32) for x in (lo, hi, w4, eid4)]
    nch, chunk = perm.shape
    per = -(-nch // THREADS)
    own = np.array([c[min(t * per, nch):min(t * per + per, nch)].sum()
                    for t in range(THREADS)], np.int64)
    excl = np.cumsum(own) - own
    off = np.empty(nch, np.int32)
    for t in range(THREADS):
        run = excl[t]
        for k in range(min(t * per, nch), min(t * per + per, nch)):
            off[k] = run
            run += c[k]
    total = int(own.sum())
    out = [np.empty(pair_cap, np.uint8)] + [np.empty(pair_cap, np.uint32)
                                            for _ in words]
    for blk in range(-(-pair_cap // (THREADS * ITEMS))):
        for j in range(blk * THREADS * ITEMS,
                       min((blk + 1) * THREADS * ITEMS, pair_cap)):
            a, b = 0, nch
            while a < b:
                mid = (a + b) >> 1
                if min(int(off[mid]), pair_cap - 1) <= j:
                    a = mid + 1
                else:
                    b = mid
            src = min(max((a - 1) * chunk + j - int(off[a - 1]), 0),
                      nch * chunk - 1)
            g = src // chunk * chunk + int(p[src])
            out[0][j] = j < total
            for o, x in zip(out[1:], words):
                o[j] = x[g]
    return (torch.from_numpy(out[0].view(np.bool_)),
            *(torch.from_numpy(o.view(x.numpy().dtype))
              for o, x in zip(out[1:], (lo, hi, w4, eid4))),
            torch.tensor(total > pair_cap))


def _equal(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(a, b))


# (nch, chunk, pair_cap, empty chunks): one block's threads one count each,
# several counts each (nch > 256), caps below, at and above the total, a
# cap of one, empty chunks at the ends and in the middle
JOIN_CASES = [(3, 8, 20, ()), (3, 8, 7, (1,)), (7, 16, 200, (0, 6)),
              (40, 4, 1, ()), (300, 3, 600, (5, 6, 299)), (513, 2, 700, ()),
              (257, 5, 4000, (0,)), (16, 64, 2048 * 2 + 5, (3,))]


@pytest.mark.parametrize("nch,chunk,cap,empty", JOIN_CASES)
def test_plain_equals_the_scan_it_replaces(nch, chunk, cap, empty):
    args = _inputs(nch, chunk, nch * 31 + chunk, empty=empty)
    assert _equal(kpj.pair_join_plain(*args, cap), _scan_join(*args, cap))


@pytest.mark.parametrize("nch,chunk,cap,empty", JOIN_CASES)
def test_kernel_decomposition_equals_plain(nch, chunk, cap, empty):
    args = _inputs(nch, chunk, nch * 17 + chunk, empty=empty)
    assert _equal(_kernel_mirror(*args, cap), kpj.pair_join_plain(*args, cap))


def test_total_equal_to_the_cap_does_not_overflow():
    args = _inputs(9, 16, 5)
    total = int(args[0].sum())
    for cap, ovf in ((total, False), (total - 1, True), (total + 1, False)):
        got = kpj.pair_join(*args, cap)
        assert bool(got[5]) is ovf and int(got[0].sum()) == min(total, cap)
        assert _equal(got, _scan_join(*args, cap))


def _bad(args, i, x):
    return [x if k == i else a for k, a in enumerate(args)]


@pytest.mark.parametrize("i,dtype", [(0, torch.int32), (1, torch.int32),
                                     (2, torch.int64), (3, torch.float32),
                                     (4, torch.float64), (5, torch.int64)])
def test_wrong_dtype_raises(i, dtype):
    args = _inputs(3, 8, 0)
    with pytest.raises(ValueError, match="pair_join: expected int64"):
        kpj.pair_join(*_bad(args, i, args[i].to(dtype)), 10)


@pytest.mark.parametrize("i,shape", [(0, (4,)), (1, (24,)), (2, (23,)),
                                     (3, (3, 8)), (4, (25,)), (5, (0,))])
def test_wrong_shape_raises(i, shape):
    args = _inputs(3, 8, 0)
    x = torch.zeros(shape, dtype=args[i].dtype)
    with pytest.raises(ValueError, match="pair_join: expected counts"):
        kpj.pair_join(*_bad(args, i, x), 10)


def test_wrong_device_raises():
    """Tensors on two devices (one on `meta`): no quiet copy."""
    args = _inputs(3, 8, 0)
    with pytest.raises(ValueError, match="all be on the CPU or all on one"):
        kpj.pair_join(*_bad(args, 2, args[2].to("meta")), 10)


def test_chunks_past_the_kernel_limit_raise():
    nch = kpj.MAX_CHUNKS + 1
    args = [torch.zeros(nch, dtype=torch.int64),
            torch.zeros((nch, 1), dtype=torch.int64),
            torch.zeros(nch, dtype=torch.int32),
            torch.zeros(nch, dtype=torch.int32),
            torch.zeros(nch, dtype=torch.float32),
            torch.zeros(nch, dtype=torch.int32)]
    with pytest.raises(ValueError, match=f"1 to {kpj.MAX_CHUNKS} chunks"):
        kpj.pair_join(*args, 10)
    # at the limit the plain version runs
    got = kpj.pair_join(*(a[:-1] for a in args), 10)
    assert not bool(got[5]) and not bool(got[0].any())


@pytest.mark.parametrize("cap", [0, -3, 2**31])
def test_pair_cap_outside_its_range_raises(cap):
    with pytest.raises(ValueError, match="pair cap"):
        kpj.pair_join(*_inputs(3, 8, 0), cap)


def test_cpu_call_launches_nothing():
    """On the CPU the plain version runs: the launch count and the
    tracing's counter stay at 0, through the dedup as well."""
    n0 = kpj.pair_join.launches
    timing.enable()
    try:
        kpj.pair_join(*_inputs(3, 8, 0), 10)
        lo = torch.tensor([0, 1, 0, turbo.INT32_MAX], dtype=torch.int32)
        turbo._chunked_pair_extract(lo, lo + 1, torch.ones(4),
                                    torch.arange(4, dtype=torch.int32), 4,
                                    chunk=2)
    finally:
        timing.disable()
        rec = timing.take()
    assert kpj.pair_join.launches == n0
    assert "pair_join.launches" not in rec.counters


def test_dedup_joins_once_a_call(monkeypatch):
    """`_chunked_pair_extract` hands its sorted chunks to the join once,
    with the sorts' permutation (nch, chunk) and the padded slots."""
    calls = []
    real = kpj.pair_join

    def rec(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(kpj, "pair_join", rec)
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 9, 37).astype(np.int32)
    hi = (lo + rng.integers(1, 4, 37)).astype(np.int32)
    turbo._chunked_pair_extract(
        torch.from_numpy(lo), torch.from_numpy(hi),
        torch.from_numpy(rng.uniform(0, 1, 37).astype(np.float32)),
        torch.arange(37, dtype=torch.int32), 30, chunk=8)
    assert len(calls) == 1
    counts, perm, plo = calls[0][:3]
    assert perm.shape == (5, 8) and counts.shape == (5,)
    assert plo.shape == (40,) and calls[0][6] == 30
    assert torch.equal(perm.sort(1).values, torch.arange(8).expand(5, 8))
