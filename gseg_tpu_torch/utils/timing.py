"""Phase timing and a profiler trace (port of `gseg_tpu.utils.timing`).

The reference wraps pipeline phases in wall-clock timers that fence the
device with a scalar fetch, and traces with `jax.profiler` for xprof.
Here a phase that hands back a CUDA tensor waits for its card with
`torch.cuda.synchronize`, which blocks until the card is done; nothing is
subtracted. `profile_trace` is `torch.profiler` writing a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

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


@contextlib.contextmanager
def profile_trace(log_dir: str = TRACE_DIR):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace to
    `log_dir/<pid>.<ns>.pt.trace.json` when the block ends: the
    counterpart of the reference's xprof trace. Yields the profiler, whose
    `key_averages()` hold the block's events once it has ended. The card
    is synchronised before the profiler stops, so the work the block
    queued is in the trace."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def device_seconds(prof) -> float:
    """Seconds of device time in a finished profile: the sum of its device
    events' durations (kernels, copies, fills), each counted once; 0.0
    when it traced no device."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
