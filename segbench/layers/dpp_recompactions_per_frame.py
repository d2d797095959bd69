"""dpp_recompactions_per_frame: the compact pool's recompactions a frame
on the DPP path, from the program's counter `dpp.recompactions`
(`models/fastmst.py:_early_rounds`: to V, then to V/4). Layer: the DPP
path, `models/fastmst.py`. Missing when the program has no such
counter."""

from segbench import program

COUNTER = "dpp.recompactions"


def instrument(tr) -> bool:
    return program.attach(tr)


def read(tr):
    n = program.finish(tr).get(COUNTER)
    if n is None or not tr.frames:
        return None
    return n / tr.frames
