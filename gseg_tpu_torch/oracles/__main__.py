"""Remake the committed oracles, every one or the named ones:

    python -m gseg_tpu_torch.oracles [name ...]
"""

import hashlib
import sys
import time

import numpy as np

from . import ORACLES, make_oracle, oracle_path

for name in sys.argv[1:] or ORACLES:
    t0 = time.perf_counter()
    labels = make_oracle(name)
    seconds = time.perf_counter() - t0
    path = oracle_path(name)
    np.savez_compressed(path, labels=labels)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    # the file's bytes carry zip timestamps; the labels' bytes do not
    labels_digest = hashlib.sha256(labels.tobytes()).hexdigest()
    print(f"{path}: {labels.shape} int32, "
          f"{np.unique(labels).size} components, {seconds:.1f} s, "
          f"file sha256 {digest}, labels sha256 {labels_digest}", flush=True)
