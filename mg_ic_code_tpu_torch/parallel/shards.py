"""One level (or one depth of one) cut over a device mesh, held as per-shard
tensors.

A `ShardSet` is how the solve holds every level the mesh cuts
(mesh.shard_counts at depth 0) from poisson_solve's placement to the end
of the solve, and every depth below it that the preconditioner cuts
(multigrid._shard_counts): the shard tensors keyed (ix, iy, iz) as
parallel/halo keys them, each on its own device, with the counts, the
devices, the mesh positions, the global shape and lo of the level. It is
a Krylov vector (arithmetic shard by shard, 0-d scalars moved to each
shard's device), the operand of the per-shard composite operator,
reductions and physics (`per_shard`), and what the writers stream tiles
from (distributed.stream_global_slabs). Levels the mesh does not cut stay
whole tensors on the mesh's home.

Every copy between mesh positions goes through this module and is
counted in ops/kernel_counts.HALO:

  level_splits / level_joins — whole tensors cut into shards / shards put
                               back together (a join into a view of a
                               parent level included): the depth chain's
                               reshards, the placement and the result;
  level_windows              — reads of the part of one level under each
                               shard (or the whole) of another, and writes
                               of such parts back (`window`,
                               `read_window`, `write_window`): the coarse
                               correction, the restricted residual, the
                               coarse-fine faces, average_down;
  coef_splits / coef_joins   — coefficient arrays cut into shards / put
                               back together (halo.shard_coefs for
                               coefficients that arrive whole; the
                               coefficient chain's reshards below a cut
                               depth);
  coef_pad_builds            — coefficient pads assembled from shards;
  pad_exchanges              — one array's boundary slabs exchanged along
                               one cut axis between all its shards;
  patch_moves                — the whole patches of a batch group (their
                               state, or their coefficients once per
                               build) copied to the mesh positions that
                               compute them, or back to every holder of
                               the whole level (`to_positions`,
                               `from_positions`): one per group and
                               direction;
  bytes_moved                — bytes of level data copied from one mesh
                               position to another (the home is position
                               0): what crosses a link when the positions
                               are distinct cards. 0-d scalars (Krylov
                               coefficients, partial sums) are not
                               counted.

OVER SEVERAL PROCESSES (mesh.Mesh's owners): a shard set holds the shards
of this process's positions only, and knows every shard's position
(`pos`); `devs` lists its own. Every function here is then collective:
every process calls it in the same order, derives the same plan of copies
from the layout and carries it out through parallel/transport.py — a split
of a whole level (which every process holds) slices it where it is, a join
or a window into a whole level gathers the parts to every process, an
exchange sends each part where it is read. Process 0 counts the events
above, the process that owns a copy's destination its bytes, so that the
processes' counts add up to those of one process.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools

import torch

from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.parallel import transport
from mg_ic_code_tpu_torch.parallel.mesh import AXES
from mg_ic_code_tpu_torch.parallel.transport import WHOLE, Transfer


def grid(mesh, counts) -> dict:
    """{(ix, iy, iz): device} of this process's shards of a level cut
    counts[axis] ways per axis; a mesh axis that does not cut the level
    puts every shard at its coordinate 0."""
    return {k: mesh.device_at(_coords(k, counts)) for k in _keys(counts)
            if mesh.is_local(mesh.position_at(_coords(k, counts)))}


def positions(mesh, counts) -> dict:
    """{(ix, iy, iz): flat mesh position} of every shard of the cut."""
    return {k: mesh.position_at(_coords(k, counts)) for k in _keys(counts)}


def _keys(counts):
    return itertools.product(*(range(c) for c in counts))


def _coords(k, counts) -> dict:
    return {AXES[ax]: k[ax] for ax in range(3) if counts[ax] > 1}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the shards of a cut live: the mesh, the counts, this
    process's shards' devices (`devs`) and every shard's position
    (`pos`). A ShardSet carries the same four."""

    mesh: object
    counts: tuple
    devs: dict
    pos: dict


def layout(mesh, counts) -> Layout:
    counts = tuple(counts)
    return Layout(mesh, counts, grid(mesh, counts), positions(mesh, counts))


def count_event(mesh, what: str) -> None:
    """One event of kernel_counts.HALO: counted by process 0 alone (every
    process makes the same events)."""
    if mesh is None or mesh.rank == 0:
        kernel_counts.HALO[what] += 1


def copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of `t` on `device`, never a view or `t` itself.
    A copy between two cards is a plain blocking copy: it is ordered after
    the kernel that wrote `t` on its card (no non_blocking copy without an
    event)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def local_slices(k, counts, shape) -> tuple:
    """The slices of shard k in an array of the global `shape`."""
    n_loc = [shape[ax] // counts[ax] for ax in range(3)]
    return tuple(slice(k[ax] * n_loc[ax], (k[ax] + 1) * n_loc[ax])
                 for ax in range(3))


def split_dict(arr, lay) -> dict:
    """This process's shards of a whole array (which every process
    holds), each copied to its device from the process's own copy of the
    whole; bytes counted where a shard's position is not the home's (0)."""
    out = {}
    plan = []
    for k in sorted(lay.pos):
        sl = local_slices(k, lay.counts, arr.shape)
        piece = arr[sl]
        plan.append(Transfer(
            WHOLE, lay.pos[k], tuple(piece.shape), arr.dtype,
            lambda piece=piece: piece,
            lambda t, k=k: out.__setitem__(k, copy_to(t, lay.devs[k]))))
    transport.exchange(lay.mesh, plan)
    return out


def join_dict(shards: dict, lay, home, shape=None, dtype=None,
              out=None) -> torch.Tensor:
    """The whole array on `home` from its shards, or written into `out`
    (a tensor or a view of one, e.g. a parent level's covered part); over
    several processes every process ends with the whole (an all-gather).
    `shape` and `dtype` are the whole's (default: from a shard of this
    process); a shard may carry leading axes only where one is here."""
    first = next(iter(shards.values()), None)
    if dtype is None:
        dtype = first.dtype
    lead = () if first is None else tuple(first.shape[:-3])
    if shape is None:
        shape = tuple(first.shape[-3 + ax] * lay.counts[ax]
                      for ax in range(3))
    shape = lead + tuple(shape[-3:])
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=home)
    assert tuple(out.shape) == shape, (tuple(out.shape), shape)
    plan = []
    for k in sorted(lay.pos):
        sl = (slice(None),) * len(lead) + local_slices(k, lay.counts,
                                                        shape[-3:])
        view = out[sl]
        plan.append(Transfer(
            lay.pos[k], WHOLE, tuple(view.shape), dtype,
            lambda k=k: shards[k], lambda t, view=view: view.copy_(t)))
    transport.exchange(lay.mesh, plan)
    return out


def on_device(x, dev):
    """A 0-d tensor moved to `dev` (a Krylov scalar, K); anything else as
    it is."""
    if isinstance(x, torch.Tensor) and x.dim() == 0 and x.device != dev:
        return x.to(dev)
    return x


def _pick(x, k, dev, counts):
    """`x` as shard k sees it: a shard set's shard k, a 0-d tensor on the
    shard's device, dicts, lists and tuples item by item."""
    if isinstance(x, ShardSet):
        assert x.counts == counts, ("shard sets of one call must be cut "
                                    "alike", x.counts, counts)
        return x.shards[k]
    if isinstance(x, dict):
        return {kk: _pick(v, k, dev, counts) for kk, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_pick(v, k, dev, counts) for v in x)
    return on_device(x, dev)


def _first_set(x):
    """The first shard set in `x` (nested dicts, lists, tuples), or None."""
    if isinstance(x, ShardSet):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for v in items:
        got = _first_set(v)
        if got is not None:
            return got
    return None


def per_shard(fn, *args, **kwargs):
    """fn applied shard by shard where an argument holds a shard set: each
    call sees shard k of every shard set (inside dicts, lists and tuples
    too) and every 0-d tensor on shard k's device; the results come back
    as a shard set of the same cut. Without a shard set among the
    arguments, fn(*args, **kwargs). Over several processes, this
    process's shards."""
    ref = _first_set((args, kwargs))
    if ref is None:
        return fn(*args, **kwargs)
    return ref.like({k: fn(*_pick(args, k, dev, ref.counts),
                           **_pick(kwargs, k, dev, ref.counts))
                     for k, dev in ref.devs.items()})


def require_whole(x, where: str):
    """Raise where a shard set reaches a path that takes whole tensors
    only: a cut level is never joined quietly."""
    if isinstance(x, ShardSet):
        raise TypeError(
            f"{where}: a level cut over the mesh reached a path that takes "
            f"whole tensors only (cut {x.counts}, shape {x.shape})")
    return x


@dataclasses.dataclass(eq=False)
class ShardSet:
    """One level (or depth) cut over the mesh: `shards[k]` on `devs[k]`,
    k = (ix, iy, iz), each of shape shape/counts (a shard may carry leading
    axes, or a ghost ring, where a per-shard function made one: `shape`
    is the level's spatial shape); `pos[k]` the mesh position of every
    shard, `home` the device a join puts the whole level on (the mesh's
    home), `mesh` the mesh. Over several processes `shards` and `devs`
    hold this process's shards alone (perhaps none: `dtype` is then the
    set's own). Arithmetic works shard by shard against a shard set of the
    same cut or a scalar, so that BiCGStab takes shard sets as its vector
    leaves."""

    shards: dict
    counts: tuple
    devs: dict
    pos: dict
    shape: tuple
    lo: tuple
    home: torch.device
    mesh: object
    dtype: torch.dtype

    @classmethod
    def split(cls, whole, mesh, counts, lo=(0, 0, 0),
              what: str = "level_splits") -> "ShardSet":
        """Cut a whole tensor (or a view), which every process holds, into
        shards on their devices: one level split, or one coefficient split
        (`what`)."""
        lay = layout(mesh, counts)
        shape = tuple(whole.shape)
        assert all(shape[ax] % lay.counts[ax] == 0 for ax in range(3)), (
            shape, lay.counts)
        count_event(mesh, what)
        return cls(split_dict(whole, lay), lay.counts, lay.devs, lay.pos,
                   shape, tuple(lo), mesh.home, mesh, whole.dtype)

    @classmethod
    def make(cls, mesh, counts, shape, fn, lo=(0, 0, 0),
             dtype=None) -> "ShardSet":
        """A shard set made in place: shards[k] = fn(k, slices of shard k
        in the level, device of k) for this process's shards; nothing is
        copied. `dtype`: the shards' (default: the first one's)."""
        lay, shape = layout(mesh, counts), tuple(shape)
        shards = {k: fn(k, local_slices(k, lay.counts, shape), dev)
                  for k, dev in lay.devs.items()}
        if shards:
            dtype = _dtype_of(next(iter(shards.values())), dtype)
        return cls(shards, lay.counts, lay.devs, lay.pos, shape, tuple(lo),
                   mesh.home, mesh, dtype)

    def join(self, out=None, what: str = "level_joins") -> torch.Tensor:
        """The whole tensor on the home device (on every process), or
        written into `out`: one level join (or one coefficient join:
        `what`)."""
        count_event(self.mesh, what)
        return join_dict(self.shards, self, self.home, self.shape,
                         self.dtype, out)

    def like(self, shards: dict, shape=None, lo=None,
             dtype=None) -> "ShardSet":
        """A shard set of the same cut holding `shards` (of a depth of
        `shape` and `lo`; default this one's)."""
        if shards:
            dtype = _dtype_of(next(iter(shards.values())), dtype)
        return ShardSet(shards, self.counts, self.devs, self.pos,
                        tuple(shape or self.shape),
                        tuple(self.lo if lo is None else lo), self.home,
                        self.mesh, dtype or self.dtype)

    def map(self, fn) -> "ShardSet":
        """fn applied to every shard, on its own device."""
        return self.like({k: fn(s) for k, s in self.shards.items()})

    def zeros_like(self) -> "ShardSet":
        return self.map(torch.zeros_like)

    def clone(self) -> "ShardSet":
        return self.map(torch.clone)

    def to(self, dtype) -> "ShardSet":
        return self.like({k: s.to(dtype) for k, s in self.shards.items()},
                         dtype=dtype)

    def axpy(self, alpha: float, x: "ShardSet") -> "ShardSet":
        """self + alpha * x, shard by shard (no copy between shards)."""
        assert x.counts == self.counts and x.shape == self.shape
        return self.like({k: s + alpha * x.shards[k]
                          for k, s in self.shards.items()})

    def _binary(self, other, op) -> "ShardSet":
        if isinstance(other, ShardSet):
            assert other.counts == self.counts and (
                other.shape == self.shape), (other.counts, self.counts)
            return self.like({k: op(s, other.shards[k])
                              for k, s in self.shards.items()})
        if isinstance(other, torch.Tensor) and other.dim() > 0:
            raise TypeError("a shard set combines with a shard set of its "
                            "cut or a scalar, not a whole tensor")
        return self.like({k: op(s, on_device(other, self.devs[k]))
                          for k, s in self.shards.items()})

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binary(other, lambda a, b: b * a)

    def region(self, whole) -> dict:
        """The part of a whole tensor (or a strided view of one, e.g. the
        coarse correction under this level) that lies under each shard,
        copied to the shard's device: `whole` has this set's counts cut
        into the same positions (one level split: the depth chain's
        prolongation from a depth that is not cut)."""
        assert all(whole.shape[ax] % self.counts[ax] == 0
                   for ax in range(3)), (tuple(whole.shape), self.counts)
        count_event(self.mesh, "level_splits")
        return split_dict(whole, self)

    def origin(self, k) -> tuple:
        """Shard k's first cell in the level's array (0-based)."""
        return tuple(k[ax] * self.n_loc[ax] for ax in range(3))

    @property
    def device(self) -> torch.device:
        """A shard's device (the home where this process holds none)."""
        return next(iter(self.shards.values())).device if self.shards \
            else self.home

    @property
    def n_loc(self) -> tuple:
        return tuple(self.shape[ax] // self.counts[ax] for ax in range(3))


def _dtype_of(t, dtype):
    """The dtype of a shard (a tensor, or a dict of them), else `dtype`."""
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return t.dtype if isinstance(t, torch.Tensor) else dtype


def zeros_like(x):
    """torch.zeros_like of a tensor or a shard set."""
    return x.zeros_like() if isinstance(x, ShardSet) else torch.zeros_like(x)


# one part of a placed level: its tensor (None where another process holds
# it), its origin in the level's array, its spatial extent, device and
# mesh position (WHOLE for a whole level, which every process holds)
Part = collections.namedtuple("Part", "t org n dev pos")


def parts(x) -> dict:
    """{key: Part} of every part of a placed level, in key order: a shard
    set's shards (this process's with their tensors), a whole tensor as
    one part."""
    if isinstance(x, ShardSet):
        return {k: Part(x.shards.get(k), x.origin(k), x.n_loc,
                        x.devs.get(k), x.pos[k]) for k in sorted(x.pos)}
    return {(0, 0, 0): Part(x, (0, 0, 0), tuple(x.shape[-3:]), x.device,
                            WHOLE)}


def _mesh_of(*xs):
    for x in xs:
        if isinstance(x, ShardSet):
            return x.mesh
    return None


def _overlap(lo_a, hi_a, lo_b, hi_b):
    lo = tuple(max(a, b) for a, b in zip(lo_a, lo_b))
    hi = tuple(min(a, b) for a, b in zip(hi_a, hi_b))
    return None if any(l >= h for l, h in zip(lo, hi)) else (lo, hi)


def _sl(lo, hi, off=(0, 0, 0)):
    return tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, off))


def window(src, regions: dict, devs: dict, pos: dict, mesh=None) -> dict:
    """One level window: for every key of `regions` (every process gives
    them all, in the same order), the box `regions[key]` = (lo, hi) of the
    placed level `src` (array coordinates, inside the level), copied to
    devs[key] from whichever of src's parts it spans (several, where src
    is cut otherwise than the reader); pos[key] is the reader's mesh
    position (WHOLE: every process reads the box). Returns the boxes of
    this process's readers. Bytes are counted where a piece's position
    differs from the reader's. `mesh`: the readers' (default src's)."""
    src_parts = parts(src)
    mesh = mesh or _mesh_of(src)
    count_event(mesh, "level_windows")
    dtype = src.dtype
    out, plan = {}, []
    for key, (lo, hi) in regions.items():
        here = pos[key] == WHOLE or mesh is None or mesh.is_local(pos[key])
        if here:
            out[key] = torch.empty(tuple(h - l for l, h in zip(lo, hi)),
                                   dtype=dtype, device=devs[key])
        for p in src_parts.values():
            hit = _overlap(lo, hi, p.org, tuple(
                o + n for o, n in zip(p.org, p.n)))
            if hit is None:
                continue
            plan.append(Transfer(
                p.pos, pos[key], tuple(h - l for l, h in zip(*hit)), dtype,
                lambda p=p, hit=hit: p.t[_sl(*hit, p.org)],
                lambda t, key=key, lo=lo, hit=hit:
                    out[key][_sl(*hit, lo)].copy_(t)))
    transport.exchange(mesh, plan)
    return out


def read_window(src, off, shape, cut=None):
    """The box of `src` at offset `off` (array coordinates) and of
    `shape`: laid out in the cut of the shard set `cut` (its counts,
    devices and positions: shard k holds the part of the box under cut's
    shard k) as a shard set of that cut, or, without `cut`, as one whole
    tensor at src's home (on every process). One level window."""
    shape = tuple(shape)
    if cut is None:
        home = src.home if isinstance(src, ShardSet) else src.device
        key = (0, 0, 0)
        hi = tuple(o + n for o, n in zip(off, shape))
        return window(src, {key: (tuple(off), hi)}, {key: home},
                      {key: WHOLE})[key]
    out = ShardSet({}, cut.counts, cut.devs, cut.pos, shape, tuple(off),
                   cut.home, cut.mesh, src.dtype)
    regions = {}
    for k in sorted(cut.pos):
        lo = tuple(o + a for o, a in zip(off, out.origin(k)))
        regions[k] = (lo, tuple(l + n for l, n in zip(lo, out.n_loc)))
    out.shards = window(src, regions, cut.devs, cut.pos, cut.mesh)
    return out


def write_window(dst, off, vals) -> None:
    """Write the placed values `vals` (a shard set or a whole tensor) into
    the box of `dst` at offset `off`, in place, each piece into whichever
    of dst's parts holds it (every process into its own copy of a whole
    `dst`): one level window."""
    mesh = _mesh_of(dst, vals)
    count_event(mesh, "level_windows")
    dst_parts = parts(dst)
    plan = []
    for v in parts(vals).values():
        lo = tuple(o + a for o, a in zip(off, v.org))
        hi = tuple(l + n for l, n in zip(lo, v.n))
        for p in dst_parts.values():
            hit = _overlap(lo, hi, p.org, tuple(
                o + n for o, n in zip(p.org, p.n)))
            if hit is None:
                continue
            plan.append(Transfer(
                v.pos, p.pos, tuple(h - l for l, h in zip(*hit)), dst.dtype,
                lambda v=v, lo=lo, hit=hit: v.t[_sl(*hit, lo)],
                lambda t, p=p, hit=hit: p.t[_sl(*hit, p.org)].copy_(t)))
    transport.exchange(mesh, plan)


# ------------------------------------------- a batch group's patches


def at_position(mesh, pos: int, t, shape, lo=(0, 0, 0),
                dtype=None) -> ShardSet:
    """A whole level held at ONE mesh position `pos` as a shard set of one
    shard (`t`, None where `pos` is another process's): how a batch group's
    patch is held where it is computed, so that level windows read and
    write it as any placed level (`parts` gives it that position)."""
    k = (0, 0, 0)
    here = mesh.is_local(pos)
    return ShardSet({k: t} if here else {}, (1, 1, 1),
                    {k: mesh.devices[pos]} if here else {}, {k: pos},
                    tuple(shape), tuple(lo), mesh.home, mesh,
                    t.dtype if t is not None else dtype)


def to_positions(mesh, tensors, positions) -> list:
    """Each whole tensor of `tensors` (which every process holds) copied to
    the device of its mesh position positions[k]: a list of the copies,
    None where the position is another process's. One plan, one
    patch_moves; bytes counted where a position is not the home's (0)."""
    count_event(mesh, "patch_moves")
    out: list = [None] * len(tensors)
    plan = []
    for i, (t, p) in enumerate(zip(tensors, positions)):
        plan.append(Transfer(
            WHOLE, p, tuple(t.shape), t.dtype, lambda t=t: t,
            lambda x, i=i, p=p: out.__setitem__(
                i, copy_to(x, mesh.devices[p]))))
    transport.exchange(mesh, plan)
    return out


def from_positions(mesh, tensors, positions, shapes, dtype) -> list:
    """The tensors held at their mesh positions (tensors[k] at
    positions[k], None where another process's) back as whole tensors on
    the home of every process. One plan, one patch_moves."""
    count_event(mesh, "patch_moves")
    out = [torch.empty(tuple(s), dtype=dtype, device=mesh.home)
           for s in shapes]
    plan = [Transfer(p, WHOLE, tuple(s), dtype, lambda i=i: tensors[i],
                     lambda x, i=i: out[i].copy_(x))
            for i, (p, s) in enumerate(zip(positions, shapes))]
    transport.exchange(mesh, plan)
    return out
