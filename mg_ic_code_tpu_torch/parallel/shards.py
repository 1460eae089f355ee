"""One depth of one level cut over a device mesh, held as per-shard tensors.

A `ShardSet` is what the preconditioner keeps between calls at every depth
the mesh cuts (multigrid._shard_counts): the shard tensors keyed
(ix, iy, iz) as parallel/halo keys them, each on its own device, with the
counts, the devices, the global shape and lo of the depth. The halo
functions (parallel/halo.py) take and return shard sets, so a level cut
over the mesh is split once when the V-cycle takes it up and joined once
when it is done, instead of once per smoother and residual call.

Every split and join goes through `split` / `join` here, and every copy
between shards through `copy_to`; each is counted in
ops/kernel_counts.HALO:

  level_splits / level_joins — whole tensors cut into shards / shards put
                               back together (a join into a view of a
                               parent level included);
  coef_splits                — coefficient arrays cut into shards
                               (halo.shard_coefs, once per coefficient
                               build, or per call where a caller's
                               coefficients carry no shards);
  coef_pad_builds            — coefficient pads assembled from shards;
  pad_exchanges              — one array's boundary slabs exchanged along
                               one cut axis between all its shards;
  bytes_moved                — bytes copied from one mesh position to
                               another (the home is position 0): what
                               crosses a link when the positions are
                               distinct cards.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.parallel.mesh import AXES


def grid(mesh, counts) -> dict:
    """{(ix, iy, iz): device} of a level cut counts[axis] ways per axis; a
    mesh axis that does not cut the level puts every shard at its
    coordinate 0."""
    return {k: mesh.device_at(_coords(k, counts)) for k in _keys(counts)}


def positions(mesh, counts) -> dict:
    """{(ix, iy, iz): flat mesh position} of the same shards."""
    return {k: mesh.position_at(_coords(k, counts)) for k in _keys(counts)}


def _keys(counts):
    return itertools.product(*(range(c) for c in counts))


def _coords(k, counts) -> dict:
    return {AXES[ax]: k[ax] for ax in range(3) if counts[ax] > 1}


def copy_to(t: torch.Tensor, device, moved: bool = True) -> torch.Tensor:
    """A contiguous copy of `t` on `device`, never a view or `t` itself.
    `moved`: the copy goes from one mesh position to another (counted in
    bytes_moved). A copy between two cards is a plain blocking copy: it
    is ordered after the kernel that wrote `t` on its card (no
    non_blocking copy without an event)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    if moved:
        kernel_counts.HALO["bytes_moved"] += t.numel() * t.element_size()
    return out


def local_slices(k, counts, shape) -> tuple:
    """The slices of shard k in an array of the global `shape`."""
    n_loc = [shape[ax] // counts[ax] for ax in range(3)]
    return tuple(slice(k[ax] * n_loc[ax], (k[ax] + 1) * n_loc[ax])
                 for ax in range(3))


def split_dict(arr, counts, devs: dict, pos: dict | None = None) -> dict:
    """The shards of a whole array, each copied to its device (bytes
    counted where the shard's position is not the home's: `pos`)."""
    return {k: copy_to(arr[local_slices(k, counts, arr.shape)], dev,
                       moved=pos is not None and pos[k] != 0)
            for k, dev in devs.items()}


def join_dict(shards: dict, counts, home, pos: dict | None = None,
              out=None) -> torch.Tensor:
    """The whole array on `home` from its shards, or written into `out`
    (a tensor or a view of one, e.g. a parent level's covered part)."""
    k0 = next(iter(shards))
    shape = tuple(shards[k0].shape[ax] * counts[ax] for ax in range(3))
    if out is None:
        out = torch.empty(shape, dtype=shards[k0].dtype, device=home)
    assert tuple(out.shape) == shape, (tuple(out.shape), shape)
    for k, s in shards.items():
        out[local_slices(k, counts, shape)].copy_(s)
        if pos is not None and pos[k] != 0:
            kernel_counts.HALO["bytes_moved"] += s.numel() * s.element_size()
    return out


@dataclasses.dataclass(eq=False)
class ShardSet:
    """One depth of one level cut over the mesh: `shards[k]` on
    `devs[k]`, k = (ix, iy, iz), each of shape shape/counts; `home` is the
    device a join puts the whole level on (the mesh's home)."""

    shards: dict
    counts: tuple
    devs: dict
    pos: dict
    shape: tuple
    lo: tuple
    home: torch.device

    @classmethod
    def split(cls, whole, mesh, counts, lo=(0, 0, 0),
              what: str = "level_splits") -> "ShardSet":
        """Cut a whole tensor (or a view) into shards on their devices:
        one level split, or one coefficient split (`what`)."""
        counts = tuple(counts)
        shape = tuple(whole.shape)
        assert all(shape[ax] % counts[ax] == 0 for ax in range(3)), (
            shape, counts)
        devs, pos = grid(mesh, counts), positions(mesh, counts)
        kernel_counts.HALO[what] += 1
        return cls(split_dict(whole, counts, devs, pos), counts, devs, pos,
                   shape, tuple(lo), mesh.home)

    def join(self, out=None) -> torch.Tensor:
        """The whole tensor on the home device, or written into `out`:
        one level join."""
        kernel_counts.HALO["level_joins"] += 1
        return join_dict(self.shards, self.counts, self.home, self.pos, out)

    def like(self, shards: dict, shape=None, lo=None) -> "ShardSet":
        """A shard set of the same cut holding `shards` (of a depth of
        `shape` and `lo`; default this one's)."""
        return ShardSet(shards, self.counts, self.devs, self.pos,
                        tuple(shape or self.shape),
                        tuple(self.lo if lo is None else lo), self.home)

    def zeros_like(self) -> "ShardSet":
        return self.like({k: torch.zeros_like(s)
                          for k, s in self.shards.items()})

    def axpy(self, alpha: float, x: "ShardSet") -> "ShardSet":
        """self + alpha * x, shard by shard (no copy between shards)."""
        assert x.counts == self.counts and x.shape == self.shape
        return self.like({k: s + alpha * x.shards[k]
                          for k, s in self.shards.items()})

    def region(self, whole) -> dict:
        """The part of a whole tensor (or a strided view of one, e.g. the
        coarse correction under this level) that lies under each shard,
        copied to the shard's device: `whole` has this set's counts cut
        into the same positions (one level split)."""
        assert all(whole.shape[ax] % self.counts[ax] == 0
                   for ax in range(3)), (tuple(whole.shape), self.counts)
        kernel_counts.HALO["level_splits"] += 1
        return split_dict(whole, self.counts, self.devs, self.pos)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    @property
    def device(self) -> torch.device:
        return next(iter(self.shards.values())).device

    @property
    def n_loc(self) -> tuple:
        return tuple(self.shape[ax] // self.counts[ax] for ax in range(3))
