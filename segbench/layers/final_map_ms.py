"""final_map_ms: host milliseconds a frame inside the program's span
`gseg.final_map` (`models/turbo.py:_final_map`: the stage-2 roots placed
on their pixels, then the value flood over the stage-G components).
Layer: the stages. Read from the program's own tracing
(`segbench/program.py`); missing when the program has none."""

from segbench import program

SPAN = "gseg.final_map"


def instrument(tr) -> bool:
    return program.attach(tr)


def read(tr):
    program.finish(tr)
    return program.per_frame_ms(tr, tr.span_seconds(SPAN))
