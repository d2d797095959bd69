"""The traced run's instruments and the reduction of its profiler trace.

A `Trace` holds what the per-layer readers (`segbench/layers/`) install
for the traced run: spans around the program's module attributes (timed
on the host's clock by the wrapper), patched methods and their counters.
It runs `torch.profiler` over the window with CUDA activity alone on a
card (the kernels, copies, fills and the CUDA runtime calls that launch
them: recording every host operator as well costs more than the frame
itself), and afterwards reduces the raw events to:

  - spans: name -> [(start_ns, end_ns)], the benchmark's own spans, moved
    onto the profiler's clock (Unix-epoch nanoseconds);
  - device: [(name, start_ns, end_ns)] of the kernels, copies and fills;
  - the window, busy_s (the union of device activity inside it) and
    window_s;
  - the breakdown: the device operations that took most time, and the
    idle gaps of the device summed by what the host was doing (the
    innermost span and the outermost runtime call inside it at each gap).

Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import importlib
import re
import time

import torch

WINDOW = "segbench.window"
FRAME = "segbench.frame"
TOP = 10


def _short(name: str) -> str:
    """A kernel's name without `void`, anonymous namespaces and its
    parameter list, at most 120 characters."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def merge(intervals):
    """Sorted, disjoint union of [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


class Trace:
    """Instruments of one traced run on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.kind = (torch.cuda.get_device_name(self.device)
                     if self.device.type == "cuda" else self.device.type)
        self.frames = 0
        self.counters: collections.Counter = collections.Counter()
        self.spans: dict = collections.defaultdict(list)
        self.device_ops: list = []
        self.window = None
        self.events_read = 0
        self._timed: list = []
        self._offset = 0
        self._undo: list = []
        self._host: list = []
        self._prof = None

    # -- set-up ------------------------------------------------------------

    def patch(self, owner, attr: str, make) -> bool:
        """Replace owner.attr by make(original) until `restore`; False
        (nothing patched) when owner has no such attribute."""
        orig = getattr(owner, attr, None)
        if orig is None:
            return False
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))
        return True

    def patch_module(self, module: str, attr: str, make) -> bool:
        try:
            mod = importlib.import_module(module)
        except ImportError:
            return False
        return self.patch(mod, attr, make)

    def span(self, module: str, attr: str, name: str) -> bool:
        """Wrap module.attr in a span called `name`."""
        def make(fn):
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                with self.record(name):
                    return fn(*args, **kwargs)
            return spanned
        return self.patch_module(module, attr, make)

    def restore(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    # -- the window --------------------------------------------------------

    @contextlib.contextmanager
    def record(self, name: str):
        """A span of the benchmark's own, on the host's clock."""
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            self._timed.append((name, t, time.perf_counter_ns()))

    @staticmethod
    def _clock_offset() -> int:
        """Profiler clock (Unix-epoch ns) minus perf_counter_ns, from the
        tightest of a few paired readings."""
        best = None
        for _ in range(7):
            a = time.perf_counter_ns()
            u = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, u - (a + b) // 2)
        return best[1]

    def start(self) -> None:
        act = (torch.profiler.ProfilerActivity.CUDA
               if self.device.type == "cuda"
               else torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=[act])
        self._prof.start()
        self._offset = self._clock_offset()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self._collect()
        self._prof = None

    def _raw_events(self):
        """(name, on_device, is_annotation, start_ns, end_ns, thread) of
        every event. A `record_function` span shows twice: on the host and
        as its range on the device; the device copy is not device work."""
        cuda = torch.autograd.DeviceType.CUDA
        res = getattr(getattr(self._prof, "profiler", None),
                      "kineto_results", None)
        if res is not None and hasattr(res, "events"):
            for e in res.events():
                yield (e.name(), e.device_type() == cuda,
                       bool(e.is_user_annotation()), e.start_ns(),
                       e.start_ns() + e.duration_ns(), e.start_thread_id())
            return
        for e in self._prof.events():  # releases without the raw results
            yield (e.name, e.device_type == cuda,
                   bool(getattr(e, "is_user_annotation", False)),
                   e.time_range.start * 1000, e.time_range.end * 1000,
                   e.thread)

    def _collect(self) -> None:
        host = []
        for name, on_dev, note, s, e, thread in self._raw_events():
            self.events_read += 1
            if note:
                continue
            if on_dev:
                self.device_ops.append((name, s, e))
            else:
                host.append((s, e, name, False, thread))
        # the window's thread issues nearly every host call
        threads = collections.Counter(h[4] for h in host)
        main = threads.most_common(1)[0][0] if threads else None
        self._host = [h for h in host if h[4] == main]
        for name, s, e in self._timed:
            s, e = s + self._offset, e + self._offset
            self.spans[name].append((s, e))
            self._host.append((s, e, name, True, main))
        if self.spans.get(WINDOW):
            self.window = self.spans[WINDOW][0]

    # -- readings ----------------------------------------------------------

    @property
    def window_s(self):
        return None if self.window is None else \
            (self.window[1] - self.window[0]) / 1e9

    def _device_in_window(self):
        if self.window is None:
            return []
        return clip([(s, e) for _, s, e in self.device_ops], *self.window)

    @property
    def busy_s(self):
        """Seconds of the window in which any kernel, copy or fill ran
        (the union, so overlapping work counts once); None when the trace
        holds no device activity."""
        busy = merge(self._device_in_window())
        if not busy:
            return None
        return sum(e - s for s, e in busy) / 1e9

    def span_seconds(self, name: str):
        """Summed seconds of the spans called `name`, None if none ran."""
        spans = self.spans.get(name)
        if not spans:
            return None
        return sum(e - s for s, e in spans) / 1e9

    def device_seconds(self, pattern: str):
        """Summed seconds of the device operations inside the window whose
        name matches the regular expression `pattern`; None if none ran."""
        if self.window is None:
            return None
        rx = re.compile(pattern)
        lo, hi = self.window
        got = [(s, e) for n, s, e in self.device_ops if rx.search(n)]
        got = clip(got, lo, hi)
        return sum(e - s for s, e in got) / 1e9 if got else None

    def breakdown(self) -> dict:
        """{"device_ops": [[name, s]], "idle_gaps": [[what the host was
        doing, s]]}, each the TOP largest."""
        if self.window is None:
            return {"device_ops": [], "idle_gaps": []}
        lo, hi = self.window
        ops = collections.Counter()
        for n, s, e in self.device_ops:
            if e > lo and s < hi:
                ops[_short(n)] += (min(e, hi) - max(s, lo)) / 1e9
        busy = merge(self._device_in_window())
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        idle = collections.Counter()
        for (s, e), what in zip(gaps, self._doing([(s + e) // 2
                                                   for s, e in gaps])):
            idle[what] += (e - s) / 1e9
        return {"device_ops": [[n, v] for n, v in ops.most_common(TOP)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(TOP)]}

    def _doing(self, points):
        """For each time point (sorted or not), "<innermost span> /
        <outermost host call inside it>" on the window's thread, by one
        sweep."""
        host = sorted(self._host, key=lambda h: (h[0], -h[1]))
        order = sorted(range(len(points)), key=points.__getitem__)
        starts = [h[0] for h in host]
        out = [None] * len(points)
        stack, j = [], 0
        for qi in order:
            t = points[qi]
            k = bisect.bisect_right(starts, t)
            while j < k:
                h = host[j]
                while stack and stack[-1][1] <= h[0]:
                    stack.pop()
                stack.append(h)
                j += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            live = [h for h in stack if h[1] > t]
            at = max((i for i, h in enumerate(live)
                      if h[3] and h[2] != WINDOW), default=-1)
            span = live[at][2] if at >= 0 else None
            # the outermost host call inside that span
            op = next((h[2] for h in live[at + 1:] if not h[3]), None)
            if span is None:
                out[qi] = "between frames" + (f" / {op}" if op else "")
            else:
                out[qi] = f"{span} / {op or 'python'}"
        return out
