"""Stage 2 in root-index space, and its CUDA-graph workspace, on the CPU.

Given the handoff's root list, `turbo._s2_stage` runs its rounds on the
roots' positions in that list; without it, on labels (V-indexed, the
rounds as they ran before). Both are driven here on states the handoff
makes from small images, in speed and quality mode, with and without
min-size rounds, on the sliced and the whole pool: fin, the flags and the
final labels must be equal, with one `s2_live` read either way. A state
whose root list overflowed must keep the V-indexed rounds, byte for byte.

The graphed rounds (`turbo._S2Graphs`) are driven with each graph
replaced by the round it records (the hand-written round's plain
version), run in place on the workspace's buffers, under a budget with
room for every phase; on a card `chip_smoke.py` and
`tests/test_torch_cuda.py` hold the real graphs to the eager rounds.
Also here: the workspace's rules (a size captured on its second frame in
a row, one size held, graphs over the budget dropped, a busy workspace
left alone), and the memory rule (`turbo._s2_graph_plan`) at the
benchmark's frame sizes, the 540p spatial frame and 8K."""

import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.utils import timing  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

# (h, w, blobs, seed, k, weight_buckets, slice taken): 96x80 frames whose
# handoff leaves few enough live pairs for the slice, or too many.
STATES = {
    "speed_slice": (96, 80, 12, 5, 120.0, 0, True),
    "speed_full": (96, 80, 12, 5, 40.0, 0, False),
    "quality_slice": (96, 80, 6, 5, 300.0, 16, True),
    "quality_full": (96, 80, 4, 7, 300.0, 16, False),
}


@pytest.fixture
def small_caps(monkeypatch):
    # capacities proportional to V at these sizes (the floors would give
    # every 96x80 frame 16,384-entry pools)
    monkeypatch.setattr(turbo, "_CAP_FLOOR", 64)
    monkeypatch.setattr(turbo, "_RLIST_FLOOR", 64)


def _handoff(h, w, blobs, seed, k, wb, min_size):
    img = torch.from_numpy(blobs_image(h, w, blobs, 6.0, seed))
    cfg = SegmentationConfig(k=k, min_size=min_size, algorithm="turbo",
                             weight_buckets=wb)
    gst, weights, thr = turbo._stage_g(img, cfg, 2)
    st, rm, r0 = turbo._extract_stage(gst, weights, cfg)
    return cfg, gst, thr, st, rm, r0


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


class _Replayed(turbo._S2Graphs):
    """The workspace with each graph's replay running the round the
    capture would record, in place on the static buffers."""

    def _capture(self, key):
        return types.SimpleNamespace(replay=lambda: self._record(key))


def _labels(gst, st, rm, r0):
    h, w = gst.L.shape
    return turbo._final_map(gst, st, rm, r0, 4 * (h + w))[0]




def _graph_everything(monkeypatch):
    # these frames' budget (3 B a pixel) holds no static buffers: room for
    # every phase, to drive the mechanism
    monkeypatch.setattr(turbo, "_S2_GRAPH_BYTES", 1 << 12)


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("min_size", [1, 20])
@pytest.mark.parametrize("state", sorted(STATES))
def test_root_space_equals_v_indexed(small_caps, monkeypatch, state,
                                     min_size, graphed):
    h, w, blobs, seed, k, wb, sliced = STATES[state]
    cfg, gst, thr, st, rm, r0 = _handoff(h, w, blobs, seed, k, wb, min_size)
    v = h * w
    assert int(st.flags) == 0
    slices = []
    slice_pool = turbo._slice_pool
    monkeypatch.setattr(turbo, "_slice_pool",
                        lambda *a: slices.append(1) or slice_pool(*a))
    want, want_c, want_spans = _traced(
        lambda: turbo._s2_stage(st, v, cfg, thr))
    assert len(slices) == int(sliced)
    _graph_everything(monkeypatch)
    ws = _Replayed(torch.device("cpu")) if graphed else None
    plan, held = turbo._s2_graph_plan(v, cfg, st.esrc.numel() // 2)
    keys = {key for key in plan.values() if key is not None}
    assert None not in plan.values()
    # a size's first frame runs op by op, its second captures, the third
    # only replays
    for frame in range(3 if graphed else 1):
        got, got_c, got_spans = _traced(
            lambda: turbo._s2_stage(st, v, cfg, thr, r0, ws))
        assert len(slices) == (2 + frame) * int(sliced)
        assert torch.equal(got.fin, want.fin)
        # (a recompact can overflow these small pools: the same bit
        # either way)
        assert int(got.flags) == int(want.flags)
        assert got.it == want.it
        assert torch.equal(_labels(gst, got, rm, r0),
                           _labels(gst, want, rm, r0))
        # root-indexed state: the root list's length, not V
        assert got.SZf.numel() == r0.numel() < v
        # the same reads: one s2_live, one s2_merged a round
        for c in (want_c, got_c):
            assert c["host_reads.s2_live"] == 1
        assert got_c["host_reads.s2_merged"] == want_c["host_reads.s2_merged"]
        assert len(got_spans) == len(want_spans) \
            == want_c["host_reads.s2_merged"]
        n_graphed = sum(s.attrs["route"] == "graph" for s in got_spans)
        # the rest call the hand-written round (on the CPU its plain
        # version)
        assert {s.attrs["route"] for s in got_spans} <= {"graph", "kernel"}
        assert got_c.get("s2_round.kernel", 0) == len(got_spans)
        assert got_c.get("s2_graph.replays", 0) == n_graphed
        assert got_c.get("s2_graph.captures", 0) == (
            len(keys) if frame == 1 else 0)
        # once captured, every round replays: the plan's keys are the
        # shapes of the rounds the stage runs
        assert n_graphed == (len(got_spans) if frame else 0)
        if frame:
            assert 0 < ws.held_bytes() == held
            # fin and the flags are not the workspace's buffers
            for x in (got.fin, got.flags):
                assert x.untyped_storage().data_ptr() not in {
                    b.untyped_storage().data_ptr() for b in ws.buffers}
    assert ws is None or not ws.busy.locked()


@pytest.mark.parametrize("graphed", [False, True])
def test_root_overflow_keeps_v_indexed_rounds(small_caps, monkeypatch,
                                              graphed):
    """More roots than the list holds (FLAG_COMP_OVERFLOW): endpoints past
    the list have no position, so the rounds stay on labels, and every
    field is byte-equal to the V-indexed stage's."""
    cfg, gst, thr, st, rm, r0 = _handoff(96, 80, 30, 7, 40.0, 0, 20)
    v = 96 * 80
    assert int(st.flags) == turbo.FLAG_COMP_OVERFLOW
    want = turbo._s2_stage(st, v, cfg, thr)

    def no_root_space(*a):
        raise AssertionError("an overflowed root list went to root space")

    monkeypatch.setattr(turbo, "_to_root_space", no_root_space)
    _graph_everything(monkeypatch)
    ws = _Replayed(torch.device("cpu")) if graphed else None
    # (a second frame of the size would capture, were the rounds graphed)
    for _ in range(2 if graphed else 1):
        got, counters, _ = _traced(
            lambda: turbo._s2_stage(st, v, cfg, thr, r0, ws))
        for name in ("esrc", "edst", "ew", "eeid", "SZf", "IDf", "fin"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert got.SZf.numel() == v
        assert int(got.flags) == int(want.flags)
        assert counters["host_reads.s2_live"] == 1
        assert "s2_graph.replays" not in counters
        assert "s2_graph.captures" not in counters


# (h, w, weight_buckets): the phases graphed, and the bytes the graphs
# keep, in 512-byte allocator blocks: 16 a slot of the largest graphed
# pool, 12 a root (SZf, IDf, fin), the hand-written round's scratch (32 a
# root and 8 a block of 1,024 roots) and four scalars; the graphs' memory
# pool stays empty. 1080p: 21,600 roots, a 172,800 pool; 4K: 86,400 roots
# and 691,200; 540p: 16,384 roots and 43,200; 8K: 345,600 roots and
# 2,764,800. Quality mode's roots (V/24) with their scratch and its first
# pools, and the photos' 16,384 roots (the floor) alone, pass 3 B a pixel.
ALL_SPEED = {"warm_full", "warm_slice", "warm_rec1", "main_felz",
             "main_min_size"}
PLANS = {
    "speed-1080p": (1080, 1920, 0, ALL_SPEED, 3718144),
    "quality-1080p": (1080, 1920, 16, set(), 0),
    "speed-4k": (2160, 3840, 0, ALL_SPEED, 14863872),
    "speed-photos": (321, 481, 0, set(), 0),
    "speed-540p": (540, 960, 0, ALL_SPEED, 1415680),
    "speed-8k": (4320, 7680, 0, ALL_SPEED, 59448320),
    "quality-8k": (4320, 7680, 16, set(), 0),
}


@pytest.mark.parametrize("cell", sorted(PLANS))
def test_graph_plan_fits_three_bytes_a_pixel(cell):
    h, w, wb, graphed, held_want = PLANS[cell]
    v = h * w
    cfg = SegmentationConfig(k=300.0, min_size=100, algorithm="turbo",
                             weight_buckets=wb)
    plan, held = turbo._s2_graph_plan(v, cfg)
    assert {p for p, key in plan.items() if key is not None} == graphed
    assert set(plan) == ({"warm_full", "warm_slice", "main_felz",
                          "main_min_size"}
                         | (set() if wb else {"warm_rec1"}))
    c = turbo.capacities(v, wb)["comp_cap"]
    assert held == held_want <= turbo._S2_GRAPH_BYTES * v
    if graphed:
        n_pool = max(key[0] for key in plan.values() if key is not None)
        assert held == turbo._s2_static_bytes(n_pool, c)
    for key in plan.values():
        if key is not None:
            assert key[1] == c
    # no min-size rounds, no min-size graph
    plan1, _ = turbo._s2_graph_plan(
        v, SegmentationConfig(k=300.0, min_size=1, weight_buckets=wb))
    assert "main_min_size" not in plan1


def test_workspace_only_on_a_card():
    assert turbo._s2_workspace(torch.device("cpu")) is None


def _plan(e):
    return {"warm_full": None,
            "main_felz": turbo._s2_graph_key(e, 8, 8, True, False, True, 1)}


def test_workspace_captures_a_size_on_its_second_frame_in_a_row():
    """One frame size's graphs at a time: a size is captured when it comes
    twice in a row (the other size's graphs then go), so a stream of
    mixed sizes captures nothing and keeps nothing new."""
    ws = _Replayed(torch.device("cpu"))
    captured = []
    capture = ws._capture
    ws._capture = lambda key: captured.append(key[0]) or capture(key)
    a, b, budget = _plan(64), _plan(32), 1 << 20
    held = [ws.prepare(p, 2.0, budget) for p in (a, a, a, b, a, b, a, b)]
    assert held == [False, True, True, False, True, False, True, False]
    assert captured == [64] and float(ws.k) == 2.0
    assert ws.esrc.numel() == 64
    assert ws.prepare(b, 3.0, budget)
    assert captured == [64, 32] and list(ws.graphs) == [b["main_felz"]]
    assert ws.esrc.numel() == 32 and float(ws.k) == 3.0
    # a plan that graphs nothing captures nothing
    none = dict.fromkeys(a)
    assert not ws.prepare(none, 3.0, budget)
    assert not ws.prepare(none, 3.0, budget)
    assert captured == [64, 32]


def test_graphs_over_the_budget_are_dropped():
    """Captured graphs whose bytes pass the budget are dropped, buffers
    and all, and their plan runs op by op without capturing again."""
    ws = _Replayed(torch.device("cpu"))
    captured = []
    capture = ws._capture
    ws._capture = lambda key: captured.append(key) or capture(key)
    plan = _plan(64)
    assert [ws.prepare(plan, 1.0, 64) for _ in range(4)] == [False] * 4
    assert len(captured) == 1
    assert ws.graphs == {} and ws.buffers == () and ws.held_bytes() == 0


def test_busy_workspace_runs_op_by_op(small_caps, monkeypatch):
    """A stage 2 that finds the card's workspace held by another thread
    runs its rounds op by op, and leaves the workspace to that thread."""
    cfg, gst, thr, st, rm, r0 = _handoff(96, 80, 12, 5, 120.0, 0, 20)
    v = 96 * 80
    _graph_everything(monkeypatch)
    ws = _Replayed(torch.device("cpu"))
    for _ in range(2):
        want = turbo._s2_stage(st, v, cfg, thr, r0, ws)
    assert ws.graphs and ws.acquire()
    try:
        got, counters, spans = _traced(
            lambda: turbo._s2_stage(st, v, cfg, thr, r0, ws))
        assert ws.busy.locked()
    finally:
        ws.release()
    assert torch.equal(got.fin, want.fin) and got.it == want.it
    assert "s2_graph.replays" not in counters
    assert {s.attrs["route"] for s in spans} == {"kernel"}


def test_live_slice_off_keeps_root_space_and_graphs(small_caps, monkeypatch):
    """`_S2_SMALL` selects the slice alone: without it the rounds still
    run in root-index space and replay graphs, decided by one `s2_live`
    read, which the V-indexed stage without the slice does not make."""
    monkeypatch.setattr(turbo, "_S2_SMALL", False)
    cfg, gst, thr, st, rm, r0 = _handoff(96, 80, 12, 5, 120.0, 0, 20)
    v = 96 * 80
    want, want_c, _ = _traced(lambda: turbo._s2_stage(st, v, cfg, thr))
    assert "host_reads.s2_live" not in want_c
    _graph_everything(monkeypatch)
    ws = _Replayed(torch.device("cpu"))
    for frame in range(3):
        got, counters, spans = _traced(
            lambda: turbo._s2_stage(st, v, cfg, thr, r0, ws))
        assert torch.equal(got.fin, want.fin)
        assert int(got.flags) == int(want.flags) and got.it == want.it
        assert got.SZf.numel() == r0.numel() < v
        assert counters["host_reads.s2_live"] == 1
        assert sum(s.attrs["route"] == "graph" for s in spans) == (
            len(spans) if frame else 0)
