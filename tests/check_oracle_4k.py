"""Hold committed oracles against the reference's NumPy Boruvka at full
size (a script, not a test: about 70 s on one CPU core for the 4K one):

    JAX_PLATFORMS=cpu python tests/check_oracle_4k.py [name ...]

With no name it checks the 4K quality-mode oracle `blobs_2160x3840_wb16`;
name the ladder's rungs (`blobs_540x960_wb0 blobs_720x1280_wb0
blobs_1440x2560_wb0`, about 25 s together) or any other entry of
`gseg_tpu_torch.oracles.ORACLES` to check those. For each it recomputes
the labels with `gseg_tpu`'s `segment_boruvka_np` and
`canonical_min_labels_np`, compares the arrays with the committed labels,
and prints the sha256 of each side's label bytes. Exits 1 when any differ.
"""

import hashlib
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from gseg_tpu.config import SegmentationConfig  # noqa: E402
from gseg_tpu.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu.utils.labels import canonical_min_labels_np  # noqa: E402
from gseg_tpu.utils.synthetic import blobs_image  # noqa: E402
from gseg_tpu_torch.oracles import (  # noqa: E402
    ORACLES, load_oracle, oracle_path)

NAME = "blobs_2160x3840_wb16"


def check(name: str) -> bool:
    h, w, wb = ORACLES[name]
    img = blobs_image(h, w, num_blobs=max(8, (h * w) // 65536), noise=8.0,
                      seed=0)
    cfg = SegmentationConfig(sigma=0.8, k=300.0, min_size=100, max_iters=32,
                             weight_buckets=wb)
    t0 = time.perf_counter()
    ref = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    seconds = time.perf_counter() - t0
    got = load_oracle(oracle_path(name))
    same = ref.dtype == got.dtype and np.array_equal(ref, got)
    for side, labels in (("gseg_tpu", ref), ("committed", got)):
        digest = hashlib.sha256(np.ascontiguousarray(labels).tobytes())
        print(f"{name} {side}: {labels.shape} {labels.dtype}, "
              f"{np.unique(labels).size} components, labels sha256 "
              f"{digest.hexdigest()}")
    print(f"{name}: reference took {seconds:.1f} s; arrays equal: {same}")
    return same


def main() -> int:
    results = [check(name) for name in sys.argv[1:] or [NAME]]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
