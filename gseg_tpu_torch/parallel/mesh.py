"""Device meshes and the ranks that run on them (the port's stand-in for
JAX's `Mesh`, `shard_map` and the `ppermute` / `psum` / `all_gather`
collectives of `gseg_tpu/parallel/`).

The reference is single-controller: one process drives every device of a
mesh. So is the port. A `Mesh` is a list of `torch.device`s with axis names
and a shape; a device may repeat, so four ranks can share one card. A rank
group (`run_ranks`) runs `fn(rank, tile)` once per rank, each in a thread
of its own (the ranks take turns between collectives, so their work is
mostly serial: `_Group`), and
hands each a `Rank`: its index, its device and the collectives, which
meet at a `threading.Barrier`:

  - `halo(x, k, fill)`: the rank's tile with the k rows above and below it
    in the global plane (they may come from several ranks, when tiles are
    shorter than k); outside the image `fill`, or the edge row repeated
    when `fill` is None;
  - `any`, `sum` and `or_flags` of host values over the ranks;
  - `all_gather_rows` (the tiles stacked in rank order) and
    `all_reduce_min` (elementwise).

Data crosses between ranks with `.to(device)`, so the same code runs with
every rank on its own card (a peer copy) or several on one. Every
collective carries a tag, and the ranks check that they all called the
same one; a rank that returns first waits at a last "done" collective.
When a rank raises, it breaks the barrier: the others stop at their next
collective, and `run_ranks` re-raises the first error. A wait longer than
the group's timeout breaks it too, so a rank that never arrives cannot
hang the caller.

A mesh of CUDA devices without a card raises `RuntimeError`: nothing
falls back to the CPU. A CPU mesh is asked for by name, as in
`spatial_mesh(["cpu"] * 8)`.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

# seconds a rank may wait at a collective for the others
TIMEOUT_S = 600.0


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {d}: no CUDA device is available; ask for a "
                "CPU mesh by name, e.g. devices=['cpu'] * 8")
        index = 0 if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {d}: only "
                               f"{torch.cuda.device_count()} CUDA devices")
        return torch.device("cuda", index)
    if d.type != "cpu":
        raise ValueError(f"mesh device {d}: only cpu and cuda devices")
    return d


def default_devices() -> list[torch.device]:
    """Every CUDA device (the reference defaults to `jax.devices()`);
    raises RuntimeError without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass the devices, "
                           "e.g. ['cpu'] * 8, to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """An n-D grid of devices: `devices` in row-major order, one axis name
    per dimension of `shape` (default: one axis over all of them). A device
    may appear more than once."""

    def __init__(self, devices, axis_names=("space",), shape=None):
        self.devices = [_device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        shape = (len(self.devices),) if shape is None else tuple(shape)
        if len(shape) != len(self.axis_names) or not self.devices \
                or math.prod(shape) != len(self.devices):
            raise ValueError(f"mesh of {len(self.devices)} devices cannot "
                             f"take shape {shape} with axes "
                             f"{self.axis_names}")
        self.grid = shape

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size (as `jax.sharding.Mesh.shape`)."""
        return dict(zip(self.axis_names, self.grid))

    def groups(self, axis: str) -> list[list[torch.device]]:
        """The device lists along `axis`, one for each index of the other
        axes, in row-major order of those indices."""
        a = self.axis_names.index(axis)
        strides = [math.prod(self.grid[i + 1:]) for i in range(len(self.grid))]
        others = [i for i in range(len(self.grid)) if i != a]
        out = []
        for flat in range(math.prod(self.grid[i] for i in others)):
            base, rem = 0, flat
            for i in reversed(others):
                base += (rem % self.grid[i]) * strides[i]
                rem //= self.grid[i]
            out.append([self.devices[base + j * strides[a]]
                        for j in range(self.grid[a])])
        return out

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={self.grid})")


def as_tensor(image) -> torch.Tensor:
    """A tensor of the image (a NumPy array or a tensor)."""
    if isinstance(image, torch.Tensor):
        return image
    return torch.as_tensor(np.asarray(image))


def row_tiles(image, devices):
    """The image's rows split evenly over the devices, each tile on its
    device; raises ValueError unless the height divides."""
    image = as_tensor(image)
    h, n = image.shape[0], len(devices)
    if h % n:
        raise ValueError(f"H={h} not divisible by mesh axis size {n}")
    hl = h // n
    return [image[i * hl:(i + 1) * hl].to(d).contiguous()
            for i, d in enumerate(devices)]


def axis_devices(mesh, axis: str):
    """The devices of a mesh whose only axis (of size > 1) is `axis`."""
    groups = mesh.groups(axis)
    if len(groups) != 1:
        raise ValueError(f"{mesh} has axes besides {axis!r}; take one row "
                         "of it (multichip_step does)")
    return groups[0]


class _Group:
    """The ranks' shared state. They take turns between collectives, one
    running at a time: threads that each dispatch many small torch ops
    hand the interpreter lock back and forth at every op (each op releases
    it), and running free was slower in every case measured (PERF.md §6:
    about 3x for the 1080p row-sharded turbo path on four ranks of one
    card and on four cards, and for a sharded batch of four 1080p images,
    one a card; many times slower on CPU meshes).

    A rank keeps the turn through its host reads, so the ranks' work is
    serial but for what a rank leaves queued on its card when it hands
    the turn on: a rank posts its reduction values without reading them
    (`_HostValue`), so on separate cards one rank's kernels of a pass run
    while the next rank dispatches its own. A rank that meets no
    collective for long (a share of `segment_batch_sharded`, a data row of
    `multichip_step`) holds the turn all that time: those run one share
    after another, and n cards give about one card's throughput."""

    def __init__(self, devices, timeout):
        self.devices = devices
        self.timeout = timeout
        self.barrier = threading.Barrier(len(devices), timeout=timeout)
        # two slot sets, used in turn: a rank can only write a set again
        # after every rank has passed the barrier of the other one.
        self.slots = [[None] * len(devices) for _ in range(2)]
        self.turn = threading.Lock()

    def take_turn(self):
        self.turn.acquire()

    def end_turn(self):
        self.turn.release()


class _HostValue:
    """A rank's bool or int for a reduction, read from its device by the
    first rank that needs it (so a rank posts it without waiting for its
    device, and each value is read once)."""

    __slots__ = ("_v",)

    def __init__(self, v):
        self._v = v

    def get(self, conv):
        if isinstance(self._v, torch.Tensor):
            self._v = conv(self._v)
        return self._v


class Rank:
    """One rank of a group: `index`, `size`, `device` and the collectives.
    Every rank must call the same collectives in the same order."""

    def __init__(self, group: _Group, index: int):
        self._group = group
        self._calls = 0
        self.index = index
        self.size = len(group.devices)
        self.device = group.devices[index]

    def _exchange(self, tag, value) -> list:
        """Every rank's value, in rank order."""
        g = self._group
        slots = g.slots[self._calls % 2]
        self._calls += 1
        slots[self.index] = (tag, value)
        g.end_turn()
        try:
            g.barrier.wait()
        except threading.BrokenBarrierError:
            g.take_turn()
            raise _Broken(f"rank {self.index}: collective {tag!r} broken "
                          "(another rank failed, or the wait passed "
                          f"{g.timeout} s)") from None
        g.take_turn()
        got = list(slots)
        tags = [t for t, _ in got]
        if any(t != tag for t in tags):
            raise RuntimeError(f"ranks called different collectives: {tags}")
        return [v for _, v in got]

    def _to(self, x):
        return x.to(self.device)

    def halo(self, x: torch.Tensor, k: int, fill) -> torch.Tensor:
        """x, this rank's row tile (rows first), with the k rows above and
        below it in the global plane; past the image's edge `fill`, or the
        edge row repeated when fill is None."""
        return self.halos([x], k, [fill])[0]

    def halos(self, xs, k: int, fills, local=None):
        """`halo` of several tiles of the same height, in one exchange.
        With `local` (a host bool or 0-d tensor), also `any(local)` in the
        same exchange: returns (slabs, any)."""
        flag = None if local is None else _HostValue(local)
        parts = self._exchange(("halo", k, flag is None), (flag, [
            (x[:k].clone(), x[-k:].clone()) for x in xs]))
        slabs = [self._pad_rows([p[1][f] for p in parts], x, k, fill)
                 for f, (x, fill) in enumerate(zip(xs, fills))]
        if local is None:
            return slabs
        return slabs, any(p[0].get(bool) for p in parts)

    def _pad_rows(self, parts, x, k, fill):
        """x with k rows a side from the ranks' (first k, last k) rows."""
        def edge(rows, need):
            if fill is None:
                return self._to(rows).expand(need, *x.shape[1:])
            return x.new_full((need, *x.shape[1:]), fill)

        above, need = [], k
        for j in range(self.index - 1, -1, -1):
            if need == 0:
                break
            rows = parts[j][1][-need:]
            above.insert(0, self._to(rows))
            need -= rows.shape[0]
        if need:
            above.insert(0, edge(parts[0][0][:1], need))
        below, need = [], k
        for j in range(self.index + 1, self.size):
            if need == 0:
                break
            rows = parts[j][0][:need]
            below.append(self._to(rows))
            need -= rows.shape[0]
        if need:
            below.append(edge(parts[-1][1][-1:], need))
        return torch.cat([*above, x, *below])

    def any(self, local) -> bool:
        """OR of a host bool or 0-d tensor over the ranks."""
        return any(v.get(bool)
                   for v in self._exchange("any", _HostValue(local)))

    def sum(self, local) -> int:
        """Sum of a host int or 0-d tensor over the ranks."""
        return sum(v.get(int)
                   for v in self._exchange("sum", _HostValue(local)))

    def or_flags(self, flags) -> int:
        """Bitwise OR of int flag masks over the ranks."""
        out = 0
        for v in self._exchange("or_flags", _HostValue(flags)):
            out |= v.get(int)
        return out

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x stacked along dim 0, in rank order, on this
        rank's device."""
        parts = self._exchange("all_gather_rows", x)
        out = torch.cat([self._to(p) for p in parts])
        self.barrier()  # every copy is enqueued before x may change
        return out

    def all_reduce_min(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise min of every rank's x, on this rank's device."""
        parts = self._exchange("all_reduce_min", x)
        out = self._to(parts[0]).clone()
        for p in parts[1:]:
            torch.minimum(out, self._to(p), out=out)
        self.barrier()
        return out

    def barrier(self) -> None:
        self._exchange("barrier", None)


class _Broken(RuntimeError):
    """A collective broken by another rank's failure or a timeout."""


def run_ranks(devices, fn, tiles=None, timeout: float = TIMEOUT_S) -> list:
    """Run fn(rank, tile) once per device, each in a thread of its own
    (taking turns between collectives), and return the results in rank
    order. tiles: one argument per rank (None: None each). Every rank ends
    at a common "done" collective, so ranks that called different
    collectives raise instead of hanging. The first error a rank raised
    (not the broken barriers it left the others) is re-raised here once
    every rank has stopped."""
    devices = [_device(d) for d in devices]
    n = len(devices)
    tiles = [None] * n if tiles is None else list(tiles)
    if len(tiles) != n:
        raise ValueError(f"{len(tiles)} tiles for {n} ranks")
    if any(d.type == "cuda" for d in devices):
        from ..ops.kernels import _build

        _build.load_all()
    group = _Group(devices, timeout)
    results, errors = [None] * n, []
    lock = threading.Lock()

    def body(i):
        rank = Rank(group, i)
        group.take_turn()
        try:
            out = fn(rank, tiles[i])
            rank._exchange("done", None)
            results[i] = out
        except BaseException as e:  # recorded, re-raised by the caller
            with lock:
                errors.append(e)
            group.barrier.abort()
        finally:
            group.end_turn()

    threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                name=f"gseg-rank-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = next((e for e in errors if not isinstance(e, _Broken)),
                     errors[0])
        raise first
    return results
