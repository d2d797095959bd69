"""Phase timing, the program's spans and counters, and a profiler trace
(port of `gseg_tpu.utils.timing`, plus the tracing).

The reference wraps pipeline phases in wall-clock timers that fence the
device with a scalar fetch, and traces with `jax.profiler` for xprof.
Here a phase that hands back a CUDA tensor waits for its card with
`torch.cuda.synchronize`, which blocks until the card is done; nothing is
subtracted. `profile_trace` is `torch.profiler` writing a Chrome trace,
with the program's spans in it.

The tracing (`enable`, `disable`, `span`, `count`, `host_read`, `take`)
is off by default. Off, `span` returns one shared no-op context manager,
`count` and `annotate` return at once and `host_read(x, site)` is
`x.item()`: nothing is recorded, allocated or locked. On, each span
records its name, its start and end on `time.perf_counter_ns()`, its
parent and a frame id (the outermost open span of a thread starts a new
frame), and a few attributes (small ints or strings); counters add up by
name. Everything stays in memory until `take()`. A sink given to `enable`
also receives `(name, start_ns, end_ns)` for each finished span, as it
finishes.

The turbo path's spans (`gseg.` names) and counters:

  gseg.segment      the body of `gseg_tpu_torch.segment`: the frame
                    (algorithm, h, w)
  gseg.stage_g, gseg.extract, gseg.stage2, gseg.final_map
                    the four stages, around their calls in
                    `models.turbo.segment_turbo_impl`
  gseg.weights, gseg.rlist
                    stage G's smoothing and edge weights, its root list
  gseg.g_round      each stage-G round, `turbo._ground` (it, sizes)
  gseg.s2_round     each stage-2 round, `turbo._s2_round`: one call of
                    the hand-written round (kind: felz or min_size)
  gseg.recompact, gseg.prune
                    stage 2's pool recompactions and dead-edge prune
  gseg.fixpoint     each dense fixpoint, `kernels.gossip._fixpoint`
                    (variant, h, w, fields, padded, closures, passes,
                    pairs)
  gseg.read.<site>  each read of a device value into the host
                    (`host_read`), counted as host_reads.<site>
  fixpoint_passes.<variant>   step passes (the plain versions' sweeps)
  closure_launches.<variant>  closure launches
  tiles.<variant>, tiles_seeded.<variant>
                    tiles the step kernel was launched over, in every
                    pass and in seeded first passes

The fastmst (DPP) path's spans and counters (`models.fastmst`; its
compact rounds are turbo's, so gseg.s2_round, gseg.recompact and
gseg.prune open inside gseg.dpp_rounds):

  gseg.dpp_round1   the dense first round at pixel scale, `_round1_dense`
  gseg.dpp_extract  the live boundary pairs into the compact pool,
                    `_extract_compact`
  gseg.dpp_rounds   every compact round, the run-out and the min-size
                    rounds, `_compact_rounds`
  gseg.dpp_final    the final map (the value flood), and the hierarchy's
                    level renders
  dpp.recompactions the pool's recompactions (to V, then to V/4)
  dpp.small_runout  frames whose run-out took the V/16 slice of the pool
  device_ns.<span>  each of the four DPP spans timed on its device too
                    (`span(..., device=)`): the nanoseconds from the
                    device reaching the span's first operation to its
                    finishing the last

The atomic path's spans and counters (`models.atomic_boruvka`, also on
its hierarchy):

  gseg.atomic_graph the smoothing, the weight planes and the incident
                    views, `prepare_graph`
  gseg.atomic_rounds
                    both phases' rounds, felz then min-size
  gseg.atomic_round each round, `_round` (mode: felz or minsize, it),
                    host only
  atomic.rounds.felz, atomic.rounds.minsize
                    the rounds run in each phase, the last one (which
                    merges nothing) included
  device_ns.gseg.atomic_graph, device_ns.gseg.atomic_rounds
                    the two outer spans timed on their device
  host_reads.atomic_merged
                    each round's one read of its merged flag,
                    `_hook_round` (the row-sharded atomic path's too)

A span given a device is timed on it as well as on the host: a host
span ends when its operations are queued, and on a card they run later.
On a CUDA card two CUDA events on the device's current stream mark the
span's ends; `take` waits for them and adds the time between them to the
counter device_ns.<name>. On the CPU the work runs as it is issued, so
the host's time is the device's. Either way nothing syncs while the
tracing records.

turbo's stage-2 retry (`models.turbo.segment_turbo_impl`):

  s2.retries        frames whose stage 2 ran again with the recompaction
                    caps raised, after the first run overflowed one
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

TRACE_DIR = os.path.join("bench_out", "torch", "trace")


def wait(x) -> None:
    """Wait for the card that x (a tensor, or a tuple or list of them)
    lives on. A CPU tensor or a host value is ready when the call that
    made it returns, and is not waited for."""
    for t in x if isinstance(x, (tuple, list)) else (x,):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class PhaseTimer:
    """Accumulates per-phase wall times.

    with timer.phase("segmentation") as out:  # waits for out["result"]
        out["result"] = run(...)

    A CUDA tensor held under "result" is waited for (its card synchronised)
    before the phase's clock stops; a CPU tensor or a host value is not.
    """

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        holder = {}
        yield holder
        wait(holder.get("result"))
        dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt

    def json(self) -> str:
        return json.dumps({k: round(v, 5) for k, v in self.phases.items()})


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------


class SpanRecord(NamedTuple):
    """One finished span: its id, name, start and end (perf_counter_ns),
    the id of the span it was opened in (None: none), its frame id and its
    attributes."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    frame: int
    attrs: dict


class Record(NamedTuple):
    """What `take` hands back: the finished spans in the order they
    finished, and the counters by name."""
    spans: list
    counters: dict


_on = False
_sink: Optional[Callable] = None
_spans: list = []
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_frames = itertools.count(1)
_read_names: Dict[str, tuple] = {}
_pending: list = []   # (counter, start event, end event) on a card


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "frame", "start",
                 "device", "event")

    def __init__(self, name, attrs, device=None):
        self.name = name
        self.attrs = attrs
        self.device = device

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.frame = stack[-1].id, stack[-1].frame
        else:
            self.parent, self.frame = None, next(_frames)
        stack.append(self)
        if self.device is not None and self.device.type == "cuda":
            self.event = _event(self.device)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        rec = SpanRecord(self.id, self.name, self.start, end, self.parent,
                         self.frame, self.attrs)
        with _lock:
            _spans.append(rec)
        if self.device is not None:
            counter = "device_ns." + self.name
            if self.device.type == "cuda":
                stop = _event(self.device)
                with _lock:
                    _pending.append((counter, self.event, stop))
            else:
                count(counter, end - self.start)
        sink = _sink
        if sink is not None:
            sink((self.name, self.start, end))
        return False


def _event(device):
    """A timing CUDA event recorded on the device's current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _NoSpan:
    """The span of tracing off: enters and exits, recording nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def enable(sink: Optional[Callable] = None) -> None:
    """Turn the tracing on (again: the same), with `sink` (None: none)
    receiving (name, start_ns, end_ns) of each span as it finishes."""
    global _on, _sink
    _sink = sink
    _on = True


def disable() -> None:
    """Turn the tracing off; what was recorded stays until `take`."""
    global _on, _sink
    _on = False
    _sink = None


def enabled() -> bool:
    """Whether the tracing is on."""
    return _on


def span(name: str, device=None, **attrs):
    """A context manager timing the block as a span called `name`, with
    the attributes `attrs` (`annotate` adds more from inside it).
    device: a torch.device to time the block's work on as well, into the
    counter device_ns.<name> (see the module's docstring)."""
    if not _on:
        return _NO_SPAN
    return _Span(name, attrs, device)


def annotate(name: str, **attrs) -> None:
    """Add attributes to this thread's innermost open span if it is called
    `name` (a callee filling in what only it knows)."""
    if not _on:
        return
    stack = _stack()
    if stack and stack[-1].name == name:
        stack[-1].attrs.update(attrs)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def host_read(x, site: str):
    """x.item(): a read of a device value into the host, which waits for
    the card. Traced, it is the span gseg.read.<site>, counted as
    host_reads.<site>."""
    if not _on:
        return x.item()
    names = _read_names.get(site)
    if names is None:
        names = _read_names.setdefault(
            site, ("gseg.read." + site, "host_reads." + site))
    with _Span(names[0], {}):
        value = x.item()
    count(names[1])
    return value


def take() -> Record:
    """What was recorded since the last take, which is cleared. Waits for
    the cards to reach the ends of their device-timed spans."""
    global _spans, _counters, _pending
    with _lock:
        rec = Record(_spans, _counters)
        pending = _pending
        _spans, _counters, _pending = [], {}, []
    for counter, start, stop in pending:
        stop.synchronize()
        ns = round(start.elapsed_time(stop) * 1e6)
        rec.counters[counter] = rec.counters.get(counter, 0) + ns
    return rec


def _clock_offset() -> int:
    """Unix-epoch ns (the profiler's clock) minus perf_counter_ns, from
    the tightest of a few paired readings."""
    best = None
    for _ in range(7):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


@contextlib.contextmanager
def profile_trace(log_dir: str = TRACE_DIR):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace to
    `log_dir/<pid>.<ns>.pt.trace.json` when the block ends: the
    counterpart of the reference's xprof trace. The program's tracing is
    on for the block (a sink given before goes on receiving), and its
    spans are written into the trace on the profiler's clock (category
    "gseg", on the block's thread). Yields the profiler, whose
    `key_averages()` hold the block's events once it has ended. The card
    is synchronised before the profiler stops, so the work the block
    queued is in the trace."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on, sink = _on, _sink
    spans = []

    def keep(s):
        spans.append(s)
        if sink is not None:
            sink(s)

    try:
        with torch.profiler.profile(activities=activities) as prof:
            offset = _clock_offset()
            enable(keep)
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        if was_on:
            enable(sink)
        else:
            disable()
    path = os.path.join(log_dir,
                        f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # Chrome trace times: microseconds since the trace's base (Unix ns)
    base = int(trace.get("baseTimeNanoseconds", 0)) - offset
    pid, tid = os.getpid(), threading.get_native_id()
    trace["traceEvents"] += [
        {"ph": "X", "cat": "gseg", "name": name, "pid": pid, "tid": tid,
         "ts": (start - base) / 1e3, "dur": (end - start) / 1e3}
        for name, start, end in spans]
    with open(path, "w") as f:
        json.dump(trace, f)


def device_seconds(prof) -> float:
    """Seconds of device time in a finished profile: the sum of its device
    events' durations (kernels, copies, fills), each counted once; 0.0
    when it traced no device."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
