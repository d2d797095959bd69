"""The port's tracing (`gseg_tpu_torch.utils.timing`: spans, counters and
host reads) on the CPU.

- One 48 x 64 turbo frame in speed and in quality mode gives the span
  tree: one `gseg.segment` a call, frame ids that increase, the four
  stages once each, in order, inside it, and every round and fixpoint
  inside its stage.
- A fastmst frame (48 x 64, and 272 x 256, whose run-out takes the V/16
  slice) gives the four `gseg.dpp_*` spans in turn, each with its
  device time (`device_ns.<span>`: on the CPU the span's own), turbo's
  stage-2 rounds inside `gseg.dpp_rounds`, its reads through
  `host_read`, and labels byte-equal to an untraced frame's.
- An atomic frame, and the atomic hierarchy, give `gseg.atomic_graph`
  and `gseg.atomic_rounds` with their device times, one
  `gseg.atomic_round` a round inside the rounds, the round counters
  `atomic.rounds.felz` / `.minsize` equal to the rounds run, and one
  `atomic_merged` read a round, traced or not.
- The host-read counters, summed over sites, equal a count of
  `torch.Tensor` reads (the benchmark's `host_reads_per_frame` patch)
  over the same frame; the fixpoint spans' passes equal the pass
  counters.
- Off, nothing is recorded and the labels are byte-equal to those of a
  traced frame.
- `profile_trace` writes the program's spans into its Chrome trace on the
  profiler's clock: a span around a `torch.mm` encloses that op's event.
- The facility itself: the shared no-op span, `enable` idempotent, the
  sink, `annotate`, frames per thread, `take` clearing.
The card's side (the kernels' passes, pairs and tiles) is in
tests/test_torch_cuda.py.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.utils import timing  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

STAGES = ["gseg.stage_g", "gseg.extract", "gseg.stage2", "gseg.final_map"]
# span -> the stage it runs in
IN_STAGE = {"gseg.g_round": "gseg.stage_g", "gseg.weights": "gseg.stage_g",
            "gseg.rlist": "gseg.stage_g", "gseg.s2_round": "gseg.stage2",
            "gseg.recompact": "gseg.stage2", "gseg.prune": "gseg.stage2"}
MODES = {"speed": 0, "quality": 16}
READS = ("item", "__bool__", "__int__", "__float__", "tolist")


@pytest.fixture
def traced():
    """Tracing on, with what it records taken; off afterwards."""
    timing.take()
    timing.enable()
    try:
        yield
    finally:
        timing.disable()
        timing.take()


def _segment(wb, seed=3):
    cfg = SegmentationConfig(algorithm="turbo", weight_buckets=wb, k=300.0,
                             min_size=20)
    return gseg_tpu_torch.segment(blobs_image(48, 64, 5, 8.0, seed),
                                  config=cfg, device="cpu")


def _ancestors(span, by_id):
    out = []
    while span.parent is not None:
        span = by_id[span.parent]
        out.append(span.name)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_span_tree_of_a_turbo_frame(traced, mode):
    _segment(MODES[mode])
    _segment(MODES[mode], seed=4)
    spans = timing.take().spans
    by_id = {s.id: s for s in spans}
    frames = [s for s in spans if s.name == "gseg.segment"]
    assert len(frames) == 2
    assert frames[0].frame < frames[1].frame
    assert all(s.parent is None for s in frames)
    assert frames[0].attrs == {"algorithm": "turbo", "h": 48, "w": 64}
    for top in frames:
        inside = [s for s in spans if s.frame == top.frame]
        stages = sorted((s for s in inside if s.name in STAGES),
                        key=lambda s: s.start_ns)
        assert [s.name for s in stages] == STAGES
        assert all(s.parent == top.id for s in stages)
        assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
        assert all(top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
                   for s in inside)
        for s in inside:
            if s is top:
                continue
            parent = by_id[s.parent]
            assert parent.frame == s.frame
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            up = _ancestors(s, by_id)
            assert up[-1] == "gseg.segment"
            if s.name in IN_STAGE:
                assert parent.name == IN_STAGE[s.name]
            if s.name == "gseg.fixpoint":
                assert parent.name in ("gseg.g_round", "gseg.final_map")
            if s.name.startswith("gseg.read."):
                assert not any(a.startswith("gseg.read.") for a in up)
        names = [s.name for s in inside]
        assert names.count("gseg.weights") == names.count("gseg.rlist") == 1
        assert names.count("gseg.recompact") >= 1
        assert names.count("gseg.g_round") >= 2
        assert names.count("gseg.s2_round") >= 1
        assert names.count("gseg.fixpoint") >= 3


DPP_SPANS = ["gseg.dpp_round1", "gseg.dpp_extract", "gseg.dpp_rounds",
             "gseg.dpp_final"]
# frame size -> whether its run-out takes the V/16 slice (past 65,536
# pixels), which the dpp_live read decides
DPP_SIZES = {"48x64": ((48, 64), False), "272x256": ((272, 256), True)}


@pytest.mark.parametrize("size", DPP_SIZES)
def test_span_tree_of_a_fastmst_frame(monkeypatch, size):
    """A traced fastmst frame: the four DPP spans in turn inside
    gseg.segment, turbo's stage-2 rounds inside gseg.dpp_rounds, every
    host read through host_read (the counters equal a patch of
    torch.Tensor's reads), and labels byte-equal to an untraced frame's."""
    (h, w), sliced = DPP_SIZES[size]
    img = blobs_image(h, w, 8, 8.0, 5)
    cfg = SegmentationConfig(algorithm="fastmst", k=150.0, min_size=20)
    timing.take()
    off = gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    seen = [0]

    def make(fn):
        def read(self, *args, **kwargs):
            seen[0] += 1
            return fn(self, *args, **kwargs)
        return read

    for m in READS:
        monkeypatch.setattr(torch.Tensor, m, make(getattr(torch.Tensor, m)))
    timing.enable()
    try:
        on = gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    finally:
        timing.disable()
        monkeypatch.undo()
    rec = timing.take()
    assert off.numpy().tobytes() == on.numpy().tobytes()
    by_id = {s.id: s for s in rec.spans}
    (top,) = [s for s in rec.spans if s.name == "gseg.segment"]
    assert top.attrs == {"algorithm": "fastmst", "h": h, "w": w}
    dpp = sorted((s for s in rec.spans if s.name in DPP_SPANS),
                 key=lambda s: s.start_ns)
    assert [s.name for s in dpp] == DPP_SPANS
    assert all(s.parent == top.id for s in dpp)
    assert all(a.end_ns <= b.start_ns for a, b in zip(dpp, dpp[1:]))
    rounds = [s for s in rec.spans if s.name in ("gseg.s2_round",
                                                 "gseg.recompact")]
    assert len(rounds) >= 3
    assert all("gseg.dpp_rounds" in _ancestors(s, by_id) for s in rounds)
    fix = [s for s in rec.spans if s.name == "gseg.fixpoint"]
    assert fix and all(by_id[s.parent].name == "gseg.dpp_final"
                       for s in fix)
    c = rec.counters
    # on the CPU the work runs as it is queued: each span's device time
    # is its own
    assert {n: c["device_ns." + n] for n in DPP_SPANS} == \
        {s.name: s.end_ns - s.start_ns for s in dpp}
    assert c["host_reads.dpp_merged"] == c["host_reads.flags"] == 1
    assert c["dpp.recompactions"] == 2
    assert c.get("host_reads.dpp_live", 0) == c.get("dpp.small_runout",
                                                    0) == int(sliced)
    reads = {k: v for k, v in c.items() if k.startswith("host_reads.")}
    assert sum(reads.values()) == seen[0] > 0
    assert sum(s.name.startswith("gseg.read.") for s in rec.spans) == \
        seen[0]


ATOMIC_SPANS = ["gseg.atomic_graph", "gseg.atomic_rounds"]


@pytest.mark.parametrize("entry", ["segment", "hierarchy"])
def test_span_tree_of_an_atomic_frame(monkeypatch, entry):
    """A traced atomic frame (and the atomic hierarchy): the graph, then
    the rounds, each timed on its device too (on the CPU the span's own
    time), one gseg.atomic_round a round inside gseg.atomic_rounds, the
    round counters equal to the rounds run, one atomic_merged read a
    round and no other read, as many reads with the tracing off, and
    labels byte-equal to an untraced frame's."""
    from gseg_tpu_torch.models import atomic_boruvka as ab

    img = blobs_image(48, 64, 5, 8.0, 6)
    cfg = SegmentationConfig(algorithm="atomic", k=300.0, min_size=20)
    if entry == "segment":
        def run():
            return gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    else:
        def run():
            return gseg_tpu_torch.segment_hierarchy(img, config=cfg,
                                                    device="cpu")[1]
    rounds, seen = [], [0]
    orig_round = ab._round

    def counted_round(state, w8, eid8, shape, k, min_size, mode):
        rounds.append(mode)
        return orig_round(state, w8, eid8, shape, k, min_size, mode)

    def make(fn):
        def read(self, *args, **kwargs):
            seen[0] += 1
            return fn(self, *args, **kwargs)
        return read

    monkeypatch.setattr(ab, "_round", counted_round)
    for m in READS:
        monkeypatch.setattr(torch.Tensor, m, make(getattr(torch.Tensor, m)))
    timing.take()
    off = run()
    assert timing.take() == timing.Record([], {})
    reads_off, rounds_off = seen[0], list(rounds)
    seen[0] = 0
    rounds.clear()
    timing.enable()
    try:
        on = run()
    finally:
        timing.disable()
    rec = timing.take()
    assert off.numpy().tobytes() == on.numpy().tobytes()
    assert rounds == rounds_off
    felz, minsize = rounds.count("felz"), rounds.count("minsize")
    assert felz >= 2 and minsize >= 1 and felz + minsize == len(rounds)
    outer = sorted((s for s in rec.spans if s.name in ATOMIC_SPANS),
                   key=lambda s: s.start_ns)
    assert [s.name for s in outer] == ATOMIC_SPANS
    assert outer[0].end_ns <= outer[1].start_ns
    each = [s for s in rec.spans if s.name == "gseg.atomic_round"]
    assert [s.attrs["mode"] for s in each] == rounds
    assert all(s.parent == outer[1].id for s in each)
    assert [s.attrs["it"] for s in each if s.attrs["mode"] == "felz"] == \
        list(range(felz))
    c = rec.counters
    assert {n: c["device_ns." + n] for n in ATOMIC_SPANS} == \
        {s.name: s.end_ns - s.start_ns for s in outer}
    assert c["atomic.rounds.felz"] == felz
    assert c["atomic.rounds.minsize"] == minsize
    reads = {k: v for k, v in c.items() if k.startswith("host_reads.")}
    assert reads == {"host_reads.atomic_merged": len(rounds)}
    assert seen[0] == reads_off == len(rounds)


@pytest.mark.parametrize("mode", MODES)
def test_host_read_counters_equal_tensor_reads(traced, monkeypatch, mode):
    """Every read of a tensor into the host in a frame goes through
    host_read: the counters equal a patch of torch.Tensor's reads."""
    _segment(MODES[mode])  # warm
    timing.take()
    seen = [0]

    def make(fn):
        def read(self, *args, **kwargs):
            seen[0] += 1
            return fn(self, *args, **kwargs)
        return read

    for m in READS:
        monkeypatch.setattr(torch.Tensor, m, make(getattr(torch.Tensor, m)))
    _segment(MODES[mode])
    rec = timing.take()
    reads = {k: v for k, v in rec.counters.items()
             if k.startswith("host_reads.")}
    assert sum(reads.values()) == seen[0] > 0
    spans = [s for s in rec.spans if s.name.startswith("gseg.read.")]
    assert len(spans) == seen[0]
    for k, v in reads.items():
        site = k.split(".", 1)[1]
        assert sum(s.name == "gseg.read." + site for s in spans) == v


@pytest.mark.parametrize("mode", MODES)
def test_fixpoint_passes_match_their_counters(traced, mode):
    _segment(MODES[mode])
    rec = timing.take()
    fix = [s for s in rec.spans if s.name == "gseg.fixpoint"]
    by_variant = {}
    for s in fix:
        a = s.attrs
        assert set(a) == {"variant", "h", "w", "fields", "padded",
                          "closures", "passes", "pairs"}
        assert (a["h"], a["w"], a["padded"], a["pairs"]) == (48, 64, 0, 0)
        assert a["passes"] >= 1
        by_variant[a["variant"]] = by_variant.get(a["variant"], 0) \
            + a["passes"]
    assert by_variant == {k.split(".", 1)[1]: v
                          for k, v in rec.counters.items()
                          if k.startswith("fixpoint_passes.")}


@pytest.mark.parametrize("mode", MODES)
def test_tracing_off_records_nothing_and_labels_match(mode):
    timing.take()
    assert not timing.enabled()
    off = _segment(MODES[mode])
    rec = timing.take()
    assert rec.spans == [] and rec.counters == {}
    timing.enable()
    try:
        on = _segment(MODES[mode])
    finally:
        timing.disable()
    assert len(timing.take().spans) > 0
    assert off.dtype == on.dtype == torch.int32
    assert off.numpy().tobytes() == on.numpy().tobytes()


def test_profile_trace_holds_the_program_spans(tmp_path):
    log_dir = tmp_path / "trace"
    a, b = torch.ones(256, 256), torch.ones(256, 256)
    with timing.profile_trace(str(log_dir)):
        with timing.span("test.mm"):
            torch.mm(a, b)
    assert not timing.enabled()
    timing.take()
    (path,) = log_dir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    (sp,) = [e for e in events if e.get("name") == "test.mm"]
    assert sp["cat"] == "gseg"
    assert sp["ts"] - 100 <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"] + 100


def test_profile_trace_keeps_an_earlier_sink(tmp_path):
    got = []
    timing.take()
    timing.enable(got.append)
    try:
        with timing.profile_trace(str(tmp_path)):
            with timing.span("test.inner"):
                pass
        assert timing.enabled()
        with timing.span("test.after"):
            pass
    finally:
        timing.disable()
        timing.take()
    assert [g[0] for g in got] == ["test.inner", "test.after"]


def test_off_is_one_shared_no_op():
    assert not timing.enabled()
    a, b = timing.span("x", n=1), timing.span("y")
    assert a is b
    with a:
        timing.annotate("x", k=2)
    timing.count("c", 3)
    timing.annotate("x", k=1)
    assert timing.host_read(torch.tensor(7), "site") == 7
    assert timing.host_read(torch.tensor([True]), "site") is True
    assert timing.take() == timing.Record([], {})


def test_enable_is_idempotent_and_the_sink_gets_each_span(traced):
    got = []
    timing.enable(got.append)
    timing.enable(got.append)
    with timing.span("outer", k=1):
        timing.annotate("outer", j="s")
        with timing.span("inner"):
            timing.annotate("inner", m=2)
            timing.annotate("outer", m=3)  # not innermost: ignored
    timing.count("n")
    timing.count("n", 4)
    rec = timing.take()
    assert [g[0] for g in got] == ["inner", "outer"]
    assert all(isinstance(g[1], int) and g[1] <= g[2] for g in got)
    inner, outer = rec.spans
    assert (inner.name, inner.parent, inner.attrs) == ("inner", outer.id,
                                                       {"m": 2})
    assert (outer.parent, outer.attrs) == (None, {"k": 1, "j": "s"})
    assert inner.frame == outer.frame
    assert [(g[1], g[2]) for g in got] == [(inner.start_ns, inner.end_ns),
                                           (outer.start_ns, outer.end_ns)]
    assert rec.counters == {"n": 5}
    assert timing.take() == timing.Record([], {})


def test_host_read_traced_is_a_span_and_a_count(traced):
    assert timing.host_read(torch.tensor(2.5), "val") == 2.5
    assert timing.host_read(torch.tensor([3], dtype=torch.int32),
                            "val") == 3
    rec = timing.take()
    assert [s.name for s in rec.spans] == ["gseg.read.val"] * 2
    assert rec.counters == {"host_reads.val": 2}


def test_each_thread_opens_its_own_frames(traced):
    def work():
        with timing.span("t.outer"):
            with timing.span("t.inner"):
                pass

    threads = [threading.Thread(target=work) for _ in range(3)]
    with timing.span("main"):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = timing.take().spans
    outer = [s for s in spans if s.name == "t.outer"]
    assert all(s.parent is None for s in outer)
    assert len({s.frame for s in outer}
               | {s.frame for s in spans if s.name == "main"}) == 4
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "t.inner":
            assert by_id[s.parent].name == "t.outer"
            assert by_id[s.parent].frame == s.frame


def test_plain_closure_and_step_pass_reads_are_traced(traced):
    rng = np.random.default_rng(0)
    L = torch.from_numpy(rng.integers(0, 3, (8, 40)).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 99, (8, 40)).astype(np.int32))
    kg.value_closure(L, val, 1)
    dst = [torch.empty_like(val)]
    kg.step_pass("value", L, [val], dst)
    counters = timing.take().counters
    assert counters["host_reads.closure_changed"] >= 1
    assert counters["host_reads.step_changed"] == 1
