"""Pad and unpad the step fixpoints' fields (wide images).

Port of `gseg_tpu/ops/pallas/gossip.py:_fast_pad_fields` and
`_fast_unpad_fields`, with:

  - the kernels: `csrc/pad.cu`, one launch for up to 4 fields of 32-bit
    words each way: bulk asynchronous copies through shared memory where
    every plane's rows are 16-byte aligned, a register copy with several
    loads in flight per thread otherwise (see the note there);
  - the plain PyTorch versions: `torch.full` plus a slice copy, and a
    slice copy.

A padded plane is (hp + 2t, wp): the (h, w) data block at rows [t, t + h),
columns [0, w), and the field's fill everywhere else. The wrappers check
the kernels' contract (1 to 4 contiguous int32/float32 planes of one
shape, the geometry) on every device, then take the plain versions for
CPU tensors and launch the kernels for CUDA tensors.
`fast_pad_fields.launches` and `fast_unpad_fields.launches` count
launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import struct

import torch

from . import _build

MAX_FIELDS = 4
_WORD_FORMATS = {torch.int32: "<i", torch.float32: "<f"}
_PTRS = ctypes.c_void_p * (2 * MAX_FIELDS)   # k inputs, then k outputs
_FILLS = ctypes.c_uint32 * MAX_FIELDS


def fast_pad_fields_plain(fields, t, hp, wp):
    """[(x, fill), ...] with (h, w) planes -> list of (hp + 2t, wp)."""
    out = []
    for x, fill in fields:
        h, w = x.shape
        p = torch.full((hp + 2 * t, wp), fill, dtype=x.dtype, device=x.device)
        p[t:t + h, :w] = x
        out.append(p)
    return out


def fast_unpad_fields_plain(fields, t, h, w):
    """List of (hp + 2t, wp) planes -> list of their (h, w) data blocks."""
    return [x[t:t + h, :w].clone() for x in fields]


@functools.cache
def _lib():
    lib = _build.load("pad")
    # in and out: addresses of arrays of k device pointers
    ptrs = [ctypes.c_void_p] * 2
    lib.gseg_pad_fields.argtypes = (
        [ctypes.c_int, *ptrs, ctypes.POINTER(ctypes.c_uint32)]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.gseg_unpad_fields.argtypes = (
        [ctypes.c_int, *ptrs] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.gseg_pad_fields.restype = ctypes.c_int
    lib.gseg_unpad_fields.restype = ctypes.c_int
    return lib


def _check(xs, what):
    """1 to MAX_FIELDS contiguous int32/float32 planes of one 2-D shape;
    returns the shape."""
    if not 1 <= len(xs) <= MAX_FIELDS:
        raise ValueError(f"{what}: 1 to {MAX_FIELDS} fields, got {len(xs)}")
    shape = xs[0].shape
    for x in xs:
        if x.dim() != 2 or x.shape != shape or not x.is_contiguous() \
                or x.dtype not in _WORD_FORMATS:
            raise ValueError(f"{what}: expected contiguous int32/float32 "
                             f"planes of one 2-D shape, got {x.dtype} "
                             f"{tuple(x.shape)} beside {tuple(shape)}")
    return shape


def _fill_word(fill, dtype) -> int:
    """The 32-bit pattern of `fill` stored as `dtype` (int32 or float32)."""
    try:
        return struct.unpack("<I", struct.pack(_WORD_FORMATS[dtype], fill))[0]
    except (struct.error, OverflowError) as e:
        raise ValueError(f"fill {fill!r} is not a {dtype} value") from e


def _launch(entry, xs, outs, *args):
    """entry(k, in, out, *args, stream) on the planes' device and its
    current stream. The wrappers' host time is not hidden behind any device
    work (one launch), so it is kept to the ctypes call and the output
    allocations."""
    k = len(xs)
    ptrs = _PTRS(*[x.data_ptr() for x in xs], *[x.data_ptr() for x in outs])
    at = ctypes.addressof(ptrs)
    out = at + k * ctypes.sizeof(ctypes.c_void_p)
    dev = xs[0].get_device()
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        return entry(k, at, out, *args,
                     torch.cuda.current_stream(dev).cuda_stream)


def fast_pad_fields(fields, t, hp, wp):
    """[(x, fill), ...] with (h, w) planes -> list of (hp + 2t, wp) planes
    (fill: a Python scalar of the plane's dtype)."""
    xs = [x for x, _ in fields]
    h, w = _check(xs, "fast_pad_fields")
    if t < 0 or hp < h or wp < w:
        raise ValueError(f"fast_pad_fields: cannot pad {(h, w)} with t={t} "
                         f"to hp={hp}, wp={wp}")
    fills = _FILLS(*[_fill_word(f, x.dtype) for x, f in fields])
    if _build.on_cpu(*xs):
        return fast_pad_fields_plain(fields, t, hp, wp)
    outs = [x.new_empty((hp + 2 * t, wp)) for x in xs]
    err = _launch(_lib().gseg_pad_fields, xs, outs, fills, h, w, t,
                  hp + 2 * t, wp)
    _build.check(err, "gseg_pad_fields")
    _build.count(_WRAPPERS["pad"])
    return outs


def fast_unpad_fields(fields, t, h, w):
    """List of (hp + 2t, wp) planes -> list of their (h, w) data blocks."""
    hpad, wp = _check(fields, "fast_unpad_fields")
    if t < 0 or h < 0 or w < 0 or hpad < t + h or wp < w:
        raise ValueError(f"fast_unpad_fields: no {(h, w)} block at row {t} "
                         f"of {(hpad, wp)}")
    if _build.on_cpu(*fields):
        return fast_unpad_fields_plain(fields, t, h, w)
    outs = [x.new_empty((h, w)) for x in fields]
    err = _launch(_lib().gseg_unpad_fields, fields, outs, h, w, t, hpad, wp)
    _build.check(err, "gseg_unpad_fields")
    _build.count(_WRAPPERS["unpad"])
    return outs


# Launch counts live on the wrapper objects themselves (bound here, so a
# caller that re-binds the module names still counts on the originals).
_WRAPPERS = {"pad": fast_pad_fields, "unpad": fast_unpad_fields}
for _fn in _WRAPPERS.values():
    _fn.launches = 0
