"""Stage 2 in root-index space, on the CPU.

Given the handoff's root list, `turbo._s2_stage` runs its rounds on the
roots' positions in that list; without it, on labels (V-indexed, the
rounds as they ran before). Both are driven here on states the handoff
makes from small images (blobs, the photo-like scene and textured
frames), in speed and quality mode, with and without min-size rounds, on
the sliced and the whole pool: fin, the flags and the final labels must
be equal, with one `s2_live` read either way. A state whose root list
overflowed must keep the V-indexed rounds, byte for byte. Stage 2 keeps
no state between calls: it leaves its input as it was, and frames of
mixed sizes, or on two threads at once, get the labels each gets alone.
On a card `chip_smoke.py` and `tests/test_torch_cuda.py` hold the
hand-written round's two label spaces to each other."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.utils import timing  # noqa: E402
from gseg_tpu_torch.utils.synthetic import (  # noqa: E402
    blobs_image, bsds_like_scene, textured_image)

# (content, h, w, blobs, seed, k, weight_buckets, slice taken): 96x80
# frames whose handoff leaves live pairs and flags 0, with few enough live
# pairs for the slice, or too many. The textured frame takes a small k: at
# k 300 it is nearly one component.
STATES = {
    "speed_slice": ("blobs", 96, 80, 12, 5, 120.0, 0, True),
    "speed_full": ("blobs", 96, 80, 12, 5, 40.0, 0, False),
    "quality_slice": ("blobs", 96, 80, 6, 5, 300.0, 16, True),
    "quality_full": ("blobs", 96, 80, 4, 7, 300.0, 16, False),
    "photos_like": ("bsds_like", 96, 80, None, 3, 150.0, 0, True),
    "textured": ("textured", 96, 80, None, 3, 12.0, 0, False),
}


@pytest.fixture
def small_caps(monkeypatch):
    # capacities proportional to V at these sizes (the floors would give
    # every 96x80 frame 16,384-entry pools)
    monkeypatch.setattr(turbo, "_CAP_FLOOR", 64)
    monkeypatch.setattr(turbo, "_RLIST_FLOOR", 64)


def _image(content, h, w, blobs, seed):
    if content == "blobs":
        img = blobs_image(h, w, blobs, 6.0, seed)
    elif content == "bsds_like":
        img = bsds_like_scene(h, w, 90, seed)[0]
    else:
        img = textured_image(h, w, seed)
    return torch.from_numpy(np.ascontiguousarray(img))


def _handoff(content, h, w, blobs, seed, k, wb, min_size):
    img = _image(content, h, w, blobs, seed)
    cfg = SegmentationConfig(k=k, min_size=min_size, algorithm="turbo",
                             weight_buckets=wb)
    gst, weights, thr = turbo._stage_g(img, cfg, 2)
    st, rm, r0 = turbo._extract_stage(gst, weights, cfg)
    return cfg, gst, thr, st, rm, r0


def _state(name, min_size=20):
    return _handoff(*STATES[name][:-1], min_size)


def _traced(fn):
    """fn() with the tracing on: (result, counters, s2_round spans)."""
    timing.take()
    timing.enable()
    try:
        out = fn()
    finally:
        timing.disable()
    rec = timing.take()
    return out, rec.counters, [s for s in rec.spans
                               if s.name == "gseg.s2_round"]


def _labels(gst, st, rm, r0):
    h, w = gst.L.shape
    return turbo._final_map(gst, st, rm, r0, 4 * (h + w))[0]


@pytest.mark.parametrize("min_size", [1, 20, 100])
@pytest.mark.parametrize("state", sorted(STATES))
def test_root_space_equals_v_indexed(small_caps, monkeypatch, state,
                                     min_size):
    sliced = STATES[state][-1]
    cfg, gst, thr, st, rm, r0 = _state(state, min_size)
    v = gst.L.numel()
    assert int(st.flags) == 0
    assert bool(torch.isfinite(st.ew).any())
    slices = []
    slice_pool = turbo._slice_pool
    monkeypatch.setattr(turbo, "_slice_pool",
                        lambda *a: slices.append(1) or slice_pool(*a))
    want, want_c, want_spans = _traced(
        lambda: turbo._s2_stage(st, v, cfg, thr))
    assert len(slices) == int(sliced)
    got, got_c, got_spans = _traced(
        lambda: turbo._s2_stage(st, v, cfg, thr, r0))
    assert len(slices) == 2 * int(sliced)
    assert torch.equal(got.fin, want.fin)
    # (a recompact can overflow these small pools: the same bit either
    # way)
    assert int(got.flags) == int(want.flags)
    assert got.it == want.it
    assert torch.equal(_labels(gst, got, rm, r0), _labels(gst, want, rm, r0))
    # root-indexed state: the root list's length, not V
    assert got.SZf.numel() == r0.numel() < v
    # the same reads: one s2_live, one s2_merged a round, a span a round
    for c in (want_c, got_c):
        assert c["host_reads.s2_live"] == 1
    assert got_c["host_reads.s2_merged"] == want_c["host_reads.s2_merged"]
    assert len(got_spans) == len(want_spans) \
        == want_c["host_reads.s2_merged"]


def test_root_overflow_keeps_v_indexed_rounds(small_caps, monkeypatch):
    """More roots than the list holds (FLAG_COMP_OVERFLOW): endpoints past
    the list have no position, so the rounds stay on labels, and every
    field is byte-equal to the V-indexed stage's."""
    cfg, gst, thr, st, rm, r0 = _handoff("blobs", 96, 80, 30, 7, 40.0, 0,
                                         20)
    v = 96 * 80
    assert int(st.flags) == turbo.FLAG_COMP_OVERFLOW
    want = turbo._s2_stage(st, v, cfg, thr)

    def no_root_space(*a):
        raise AssertionError("an overflowed root list went to root space")

    monkeypatch.setattr(turbo, "_to_root_space", no_root_space)
    got, counters, _ = _traced(lambda: turbo._s2_stage(st, v, cfg, thr, r0))
    for name in ("esrc", "edst", "ew", "eeid", "SZf", "IDf", "fin"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got.SZf.numel() == v
    assert int(got.flags) == int(want.flags)
    assert counters["host_reads.s2_live"] == 1


def test_live_slice_off_keeps_root_space(small_caps, monkeypatch):
    """`_S2_SMALL` selects the slice alone: without it the rounds still
    run in root-index space, decided by one `s2_live` read, which the
    V-indexed stage without the slice does not make."""
    monkeypatch.setattr(turbo, "_S2_SMALL", False)
    cfg, gst, thr, st, rm, r0 = _state("speed_slice")
    v = gst.L.numel()
    want, want_c, _ = _traced(lambda: turbo._s2_stage(st, v, cfg, thr))
    assert "host_reads.s2_live" not in want_c
    got, counters, _ = _traced(lambda: turbo._s2_stage(st, v, cfg, thr, r0))
    assert torch.equal(got.fin, want.fin)
    assert int(got.flags) == int(want.flags) and got.it == want.it
    assert got.SZf.numel() == r0.numel() < v
    assert counters["host_reads.s2_live"] == 1


@pytest.mark.parametrize("state", sorted(STATES))
def test_stage_leaves_its_input_as_it_was(small_caps, state):
    """Every tensor of the handoff's state, the root list and the bucket
    caps are as they came after stage 2, in root space and V-indexed."""
    cfg, gst, thr, st, rm, r0 = _state(state)
    v = gst.L.numel()
    fields = [f for f in st._fields if isinstance(getattr(st, f),
                                                  torch.Tensor)]
    before = {f: getattr(st, f).clone() for f in fields}
    r0_before = r0.clone()
    thr_before = None if thr is None else thr.clone()
    for roots in (r0, None):
        out = turbo._s2_stage(st, v, cfg, thr, roots)
        assert out.it > 0
        for f in fields:
            assert torch.equal(getattr(st, f), before[f]), f
        assert torch.equal(r0, r0_before)
        assert thr is None or torch.equal(thr, thr_before)


# (h, w, blobs, seed, k, weight_buckets): two frame sizes a mode
MIXED = {"speed": [(96, 80, 12, 5, 120.0, 0), (64, 72, 8, 3, 120.0, 0)],
         "quality": [(96, 80, 6, 5, 300.0, 16), (64, 72, 5, 3, 300.0, 16)]}


def _frame(h, w, blobs, seed, k, wb):
    img = torch.from_numpy(blobs_image(h, w, blobs, 6.0, seed))
    return img, SegmentationConfig(k=k, min_size=20, algorithm="turbo",
                                   weight_buckets=wb)


@pytest.mark.parametrize("mode", sorted(MIXED))
def test_mixed_sizes_get_their_own_labels(small_caps, mode):
    """Frames of two sizes in the order A, B, A: each gets the labels and
    flags it gets alone."""
    a, b = (_frame(*f) for f in MIXED[mode])
    alone = [turbo.segment_turbo_impl(img, cfg) for img, cfg in (a, b)]
    assert alone[0][0].shape != alone[1][0].shape
    for (img, cfg), (want, want_fl) in zip((a, b, a),
                                           (alone[0], alone[1], alone[0])):
        got, fl = turbo.segment_turbo_impl(img, cfg)
        assert fl == want_fl == 0
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", sorted(MIXED))
def test_two_threads_get_their_own_labels(small_caps, mode):
    """Two threads segment different frames at once: each gets its answer
    of one thread."""
    frames = [_frame(*f) for f in MIXED[mode]]
    alone = [turbo.segment_turbo_impl(img, cfg) for img, cfg in frames]
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def run(i):
        try:
            start.wait()
            got[i] = [turbo.segment_turbo_impl(*frames[i]) for _ in range(2)]
        except Exception as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for i, (want, want_fl) in enumerate(alone):
        for lab, fl in got[i]:
            assert fl == want_fl == 0
            assert torch.equal(lab, want)
