"""atomic_rounds_per_frame: the atomic path's Boruvka rounds a frame, felz
and min-size together, from the program's counters `atomic.rounds.felz`
and `atomic.rounds.minsize` (`models/atomic_boruvka.py:_round`; the last
round of each phase, which merges nothing, counts). Each round is a
fixed set of V-sized operations and one host read, so the rounds set the
path's work. Layer: the atomic path, `models/atomic_boruvka.py`. Missing
when the program has neither counter."""

from segbench import program

COUNTERS = ("atomic.rounds.felz", "atomic.rounds.minsize")


def instrument(tr) -> bool:
    return program.attach(tr)


def read(tr):
    got = program.finish(tr)
    if not tr.frames or not any(c in got for c in COUNTERS):
        return None
    return sum(got.get(c, 0) for c in COUNTERS) / tr.frames
