"""Entry point of the benchmark: one run of one cell (see harness.py).

    python3 segbench/run.py --workload speed-1080p --seed 7 --seconds 30 \\
        --trace 0

Run from the root of a checkout. Caches go into fixed directories inside
the checkout: the program builds its kernels into its own
`gseg_tpu_torch/_build/`, and Triton's and the CUDA driver's caches are
pointed at `.segbench_cache/`.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".segbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from segbench.harness import main

    sys.exit(main(t0=T0))
