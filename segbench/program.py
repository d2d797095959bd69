"""The program's own spans and counters in a traced run.

`gseg_tpu_torch.utils.timing` records spans and counters inside the
program while its tracing is on. `attach(tr)` turns it on for the traced
run with a sink that hands each finished span to the `Trace` the way the
benchmark's own spans enter it (`Trace.record`: name, start and end on
`perf_counter_ns`), so `Trace._collect` moves them onto the profiler's
clock with the rest and `breakdown()` puts each idle gap down to the
innermost of them. `finish(tr)`, which every reader calls when it reads,
turns the tracing off after the window and takes the program's counters
once. A program without the tracing has
nothing to attach: its readers find nothing, and their metrics are
missing from the line.
"""

from __future__ import annotations

READ = "gseg.read."


def _timing():
    try:
        from gseg_tpu_torch.utils import timing
    except ImportError:
        return None
    if not all(hasattr(timing, f) for f in ("enable", "disable", "take")):
        return None
    return timing


def attach(tr) -> bool:
    """Turn the program's tracing on for tr's window (once, however many
    readers ask); False when the program has none."""
    timing = _timing()
    if timing is None:
        return False
    if not getattr(tr, "program_attached", False):
        timing.take()  # what an earlier caller left
        timing.enable(tr._timed.append)
        tr.program_attached = True
    return True


def finish(tr) -> dict:
    """Turns the program's tracing off (once) and returns its counters
    over the window: name -> count ({} when nothing was attached)."""
    got = getattr(tr, "program_counters", None)
    if got is None:
        timing = _timing()
        if timing is None or not getattr(tr, "program_attached", False):
            return {}
        timing.disable()
        got = tr.program_counters = timing.take().counters
    return got


def per_frame_ms(tr, seconds):
    """seconds over the window's frames, in ms; None when nothing ran."""
    if seconds is None or not tr.frames:
        return None
    return seconds * 1e3 / tr.frames


def read_seconds(tr):
    """Summed seconds of the program's host-read spans (gseg.read.<site>),
    None when there were none."""
    names = [n for n in tr.spans if n.startswith(READ)]
    if not names:
        return None
    return sum(tr.span_seconds(n) for n in names)
