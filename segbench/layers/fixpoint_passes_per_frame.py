"""fixpoint_passes_per_frame: the fixpoints' step passes plus their
closure launches a frame, from the program's counters
`fixpoint_passes.<variant>` and `closure_launches.<variant>` (on the CPU
the plain versions' sweeps count as passes). Each pass is a launch and a
read of its `changed` word: fewer passes are less device work and fewer
waits. Layer: the kernels, `ops/kernels/gossip.py` -> `csrc/gossip.cu`,
`csrc/closure.cu`. Missing when the program has no tracing."""

from segbench import program

PREFIXES = ("fixpoint_passes.", "closure_launches.")


def instrument(tr) -> bool:
    return program.attach(tr)


def read(tr):
    got = [n for name, n in program.finish(tr).items()
           if name.startswith(PREFIXES)]
    if not got or not tr.frames:
        return None
    return sum(got) / tr.frames
