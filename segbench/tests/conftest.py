"""A benchmark root at a size a CPU test holds: BENCHMARK.json and the
files of segbench/, copied, with every traffic mix cut to 48 x 64 frames
(the photos' mix to 40 x 56) and a pool of two."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def make_tiny_root(dst: Path) -> Path:
    shutil.copytree(REPO / "segbench", dst / "segbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for path in (dst / "segbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        small = (40, 56) if t["content"] == "bsds_like" else (48, 64)
        t.update(height=small[0], width=small[1], pool=2)
        if t["content"] == "blobs":
            t["num_blobs"] = 5
        if t["content"] == "bsds_like":
            t["n_regions"] = 6
        path.write_text(json.dumps(t))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
