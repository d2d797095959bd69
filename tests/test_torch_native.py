"""The port's native C++ baseline (`gseg_tpu_torch.native`) against
`gseg_tpu.native`, on the CPU.

- `felz.cpp` is a byte-for-byte copy of the reference's source, and the
  port builds it into `gseg_tpu_torch/_build/` with g++ and the
  reference Makefile's flags (the reference's folder is not touched).
- `segment_kruskal_native`: root ids byte-equal to the reference
  library's on blobs, textured, grey and one-row images; and through
  `segment(algorithm="kruskal_native")`, byte-equal to the reference's
  `segment`, on any `device` the caller names. `segment_hierarchy`
  refuses the route, as the reference does.
- `asa_ue_native` equal to NumPy's `asa_ue` within 1e-12 (C++ divides
  the same integer sums; the bound allows for another order of the
  float64 arithmetic).
- A source that does not compile raises RuntimeError with g++'s stderr.
- `_build.host_cpu` (the label of host-only times) and the build key
  that `-march=native` needs come from one reading of /proc/cpuinfo.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gseg_tpu  # noqa: E402
from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.native import bindings as ref_native  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.metrics.compare import asa_ue  # noqa: E402
from gseg_tpu_torch.native import bindings  # noqa: E402
from gseg_tpu_torch.ops.kernels import _build  # noqa: E402
from gseg_tpu_torch.utils.synthetic import (  # noqa: E402
    blobs_ground_truth, blobs_image, bsds_like_scene, textured_image)

NATIVE_TOL = 1e-12


def test_felz_cpp_is_the_reference_copy():
    from pathlib import Path

    ref = Path(ref_native.__file__).resolve().parent / "felz.cpp"
    assert bindings.SOURCE.read_bytes() == ref.read_bytes()
    assert bindings.available()
    built = sorted(_build.BUILD_DIR.glob("libfelz_*.so"))
    assert built, "felz.cpp was not built into gseg_tpu_torch/_build/"
    assert _build.HOST_FLAGS[:5] == ["-O3", "-march=native", "-fPIC",
                                     "-std=c++17", "-Wall"]


def _image(kind):
    if kind == "blobs":
        return blobs_image(48, 64, 6, 8.0, 1)
    if kind == "textured":
        return textured_image(40, 52, seed=2)
    if kind == "grey":
        return blobs_image(30, 41, 5, 8.0, 3)[..., 0]
    return blobs_image(1, 97, 4, 8.0, 4)


@pytest.mark.parametrize("kind", ["blobs", "textured", "grey", "row"])
@pytest.mark.parametrize("k,min_size", [(80.0, 10), (300.0, 1)])
def test_segment_kruskal_native_byte_equal(kind, k, min_size):
    img = _image(kind)
    cfg = SegmentationConfig(k=k, min_size=min_size)
    got = bindings.segment_kruskal_native(img, cfg)
    want = ref_native.segment_kruskal_native(img, RefConfig(k=k,
                                                            min_size=min_size))
    assert got.dtype == np.int32 and got.shape == img.shape[:2]
    assert np.array_equal(got, want)


def test_segment_routes_kruskal_native():
    img = blobs_image(40, 50, 5, 8.0, 6)
    want = np.asarray(gseg_tpu.segment(img, k=120.0, min_size=15,
                                       algorithm="kruskal_native"))
    got = gseg_tpu_torch.segment(img, k=120.0, min_size=15,
                                 algorithm="kruskal_native", device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    got = gseg_tpu_torch.segment(torch.from_numpy(img), k=120.0,
                                 min_size=15, algorithm="kruskal_native",
                                 device="cpu")
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="no hierarchy mode"):
        gseg_tpu.segment_hierarchy(img, algorithm="kruskal_native")
    with pytest.raises(ValueError, match="no hierarchy mode"):
        gseg_tpu_torch.segment_hierarchy(img, algorithm="kruskal_native",
                                         device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_asa_ue_native_equals_numpy(seed):
    img, gts = bsds_like_scene(40, 60, n_regions=16, seed=seed)
    seg = bindings.segment_kruskal_native(
        img, SegmentationConfig(k=80.0, min_size=10))
    for gt in gts + [blobs_ground_truth(40, 60, 3, seed)]:
        a, u = bindings.asa_ue_native(seg, gt)
        na, nu = asa_ue(seg, gt)
        assert abs(a - na) <= NATIVE_TOL and abs(u - nu) <= NATIVE_TOL
        assert (a, u) == ref_native.asa_ue_native(seg, gt)
    with pytest.raises(ValueError, match="same size"):
        bindings.asa_ue_native(seg, gts[0][:-1])


def test_failed_build_raises_with_compiler_stderr(tmp_path):
    src = tmp_path / "broken_src.cpp"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed on .*error:"):
        _build.load_host(src)
    assert not list(_build.BUILD_DIR.glob("libbroken_src_*"))


def test_host_cpu_labels_and_keys_the_build():
    """host_cpu() names the CPU and its cores for host-only times; the
    build key is the CPU's model name and feature flags, so the library
    name stays the same from run to run on one host."""
    label = _build.host_cpu()
    assert label.endswith(f", {os.cpu_count()} cores") and label[0] != ","
    assert _build._host_key() == _build._host_key()
    assert _build._cpuinfo().get("model name", "") in \
        _build._host_key().decode()
