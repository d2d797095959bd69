"""segbench: the benchmark of `gseg_tpu_torch`, the PyTorch and CUDA port.

One run measures one cell of `BENCHMARK.json` (a configuration under a
traffic mix) on one H100:

    python3 segbench/run.py --workload speed-1080p --seed 7 --seconds 30 \\
        --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name:
`segbench/configs/<config>.json`, `segbench/traffic/<traffic>.json`,
`segbench/layers/<metric>.py`. The yardstick lives here too: the frame
generators (`synthetic.py`), the plain reference (`reference.py`), the
comparison that decides `correct` (`check.py`), the reduction of a
profiler trace (`trace.py`) and the peaks and byte counts of the rooflines
(`roofline.py`). Nothing here imports `jax` or `gseg_tpu`.
"""
