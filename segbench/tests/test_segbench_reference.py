"""The yardstick's frozen parts: the reference against the committed
oracle record, the generators byte-equal to the program's, the
bfloat16 rounding of the control."""

import hashlib

import numpy as np
import pytest

from segbench import frames, reference, synthetic
from gseg_tpu_torch.oracles import RECORDED
from gseg_tpu_torch.utils import synthetic as program_synthetic

BENCH = dict(sigma=0.8, k=300.0, min_size=100, max_iters=32, connectivity=8)


@pytest.mark.parametrize("name,wb", [("blobs_540x960_wb0", 0),
                                     ("blobs_540x960_wb16", 16)])
def test_reference_reproduces_recorded_oracle(name, wb):
    img = synthetic.blobs_image(540, 960, max(8, 540 * 960 // 65536), 8.0, 0)
    labels = reference.reference_partition(img, BENCH | {"weight_buckets": wb})
    count, sha = RECORDED[name]
    assert len(np.unique(labels)) == count
    assert hashlib.sha256(labels.tobytes()).hexdigest() == sha


@pytest.mark.parametrize("h,w,blobs,seed", [(60, 80, 6, 0),
                                            (321, 481, 8, 2**31 + 5),
                                            (2048, 2049, 9, 77)])
def test_blobs_byte_equal_to_program(h, w, blobs, seed):
    # 2048 x 2049 passes 1 << 22 pixels: the chunked float32 route
    assert np.array_equal(synthetic.blobs_image(h, w, blobs, 8.0, seed),
                          program_synthetic.blobs_image(h, w, blobs, 8.0,
                                                        seed))


@pytest.mark.parametrize("seed", [0, 3_000_000_017])
def test_bsds_like_and_textured_byte_equal_to_program(seed):
    img, _ = program_synthetic.bsds_like_scene(321, 481, 90, seed)
    assert np.array_equal(synthetic.bsds_like_image(321, 481, 90, seed), img)
    assert np.array_equal(synthetic.textured_image(50, 70, seed),
                          program_synthetic.textured_image(50, 70, seed))


@pytest.mark.parametrize("seed", [0, 41, 3_000_000_017])
@pytest.mark.parametrize("h,w", [(48, 64), (96, 160)])
def test_textured_byte_equal_to_program(h, w, seed):
    got = frames.make_pool({"content": "textured", "height": h, "width": w,
                            "pool": 1}, seed)[0]
    assert np.array_equal(got, synthetic.textured_image(
        h, w, frames.frame_seeds(seed, 1)[0]))
    assert np.array_equal(synthetic.textured_image(h, w, seed),
                          program_synthetic.textured_image(h, w, seed))


def test_pool_is_a_function_of_the_seed():
    t = {"content": "blobs", "height": 30, "width": 40, "num_blobs": 4,
         "noise": 8.0, "pool": 3}
    a, b = frames.make_pool(t, 2**40 + 3), frames.make_pool(t, 2**40 + 3)
    c = frames.make_pool(t, -7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert len({x.tobytes() for x in a}) == 3
    assert all(x.shape == (30, 40, 3) and x.dtype == np.uint8 for x in c)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.0e-5, np.inf, 255.7],
                 np.float32)
    got = reference.to_bfloat16(x)
    # 1 + 2^-8 is halfway between 1 and 1 + 2^-7: ties to even -> 1
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == np.float32(1.0078125)
    assert got[4] == np.inf
    u = got.view(np.uint32)
    assert np.all(u & 0xFFFF == 0)
    assert np.all(np.abs(got[np.isfinite(x)] - x[np.isfinite(x)])
                  <= np.abs(x[np.isfinite(x)]) * 2.0**-8)


def test_canonical_labels_is_a_partition_form():
    a = np.array([[5, 5, 2], [2, 9, 9]])
    b = np.array([[0, 0, 7], [7, 1, 1]])
    assert np.array_equal(reference.canonical_labels(a),
                          reference.canonical_labels(b))
    assert reference.canonical_labels(a).tolist() == [[0, 0, 2], [2, 4, 4]]
