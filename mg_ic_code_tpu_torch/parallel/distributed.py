"""Process bootstrap and host-aware mesh construction (one process).

Port of the single-process parts of the JAX package's
`parallel/distributed.py` (the reference's MPI_Init / MPI_Finalize role,
Main_PoissonSolver.cpp:261-263): the mesh over the visible cards, the
topology chooser, and the tile streaming the HDF5 writers read levels
through. A run over several processes (torch.distributed with NCCL) is a
later step: `initialize` refuses it rather than run alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mg_ic_code_tpu_torch.parallel import mesh as pmesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """No-op on one process. Asked for more than one process, it raises:
    the multi-process runtime is not ported yet, and a run that was meant
    to span processes must not quietly run alone."""
    if coordinator_address is not None or (num_processes or 1) > 1 or (
            process_id or 0) > 0:
        raise NotImplementedError(
            "multi-process runs (torch.distributed / NCCL) are not ported "
            "yet: run one process over the visible cards")


def choose_mesh_shape(
    n_cells: tuple[int, int, int], ndev: int
) -> tuple[int, ...]:
    """Mesh topology for a base grid of `n_cells` on `ndev` devices: 1-D x
    slabs (one exchange axis) when x alone gives every device a useful slab
    (>= MIN_LOCAL_NX rows, evenly dividing — the rule mesh.shard_counts
    cuts by); else the most slab-like (x, y) pencil that does. It NEVER emits a
    z axis: an (x, y) pencil of equal device count moves no more halo data
    than an (x, z) one on these grids, and z is the axis every kernel keeps
    whole. A z-cut mesh comes only from mesh.make_mesh by hand."""
    nx, ny = n_cells[0], n_cells[1]

    def ok(n, s):
        return s == 1 or (n % s == 0 and n // s >= pmesh.MIN_LOCAL_NX)

    if ok(nx, ndev):
        return (ndev,)
    for sx in range(ndev - 1, 0, -1):
        if ndev % sx:
            continue
        sy = ndev // sx
        if ok(nx, sx) and ok(ny, sy):
            return (sx, sy)
    return (ndev,)  # nothing divides usefully: level_spec keeps levels whole


def host_mesh(n_cells: tuple[int, int, int] | None = None, devices=None):
    """Mesh over the visible cards in index order (`devices` None), or over
    `devices`; with `n_cells` its 1-D-versus-pencil topology comes from
    choose_mesh_shape. Raises where there is no CUDA device and none is
    named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("host_mesh: no CUDA device available")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    shape = (n,) if n_cells is None else choose_mesh_shape(n_cells, n)
    return pmesh.make_mesh(devices, shape)


def is_coordinator() -> bool:
    """Whether this process writes the files: always, on one process. The
    JAX package's API, for the multi-process slice; no path of the port
    asks it yet."""
    return True


def gather_global(x):
    """The full value of a level as host numpy (a tensor on any device, or
    an array already on the host). The JAX package's API; the port's
    writers stream tiles (stream_global_slabs) and only
    tests/test_torch_parallel.py calls this."""
    from mg_ic_code_tpu_torch.parallel.shards import require_whole

    if isinstance(x, np.ndarray):
        return x
    require_whole(x, "gather_global (stream_global_slabs reads shards)")
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stream_global_slabs(x, axis: int = 0, max_bytes: int = 1 << 25,
                        perm: tuple[int, ...] | None = None):
    """Yield (start, host numpy block) tiles of `x` along `axis`, each of
    at most `max_bytes` (at least one slice), so that no more than one tile
    is ever on the host. `perm`, when given, permutes each tile's axes on
    the device before the copy (the writers ask for Fortran order this
    way). A host array yields itself as one tile.

    A level cut over the mesh (parallel/shards.ShardSet, its shards
    perhaps with leading axes, as the writers' component stacks) yields
    the same tiles as the whole level would: each tile is put together on
    the host from the part of it every shard holds, copied from the
    shard's device (permuted there), and no shard is joined on a card."""
    from mg_ic_code_tpu_torch.parallel.shards import ShardSet

    if isinstance(x, np.ndarray):
        yield 0, x if perm is None else x.transpose(perm)
        return
    if isinstance(x, ShardSet):
        yield from _shard_tiles(x, axis, max_bytes, perm)
        return
    n = x.shape[axis]
    row_bytes = (x.numel() // max(n, 1)) * x.element_size()
    rows = max(1, min(n, int(max_bytes) // max(row_bytes, 1)))
    for a in range(0, n, rows):
        tile = x.narrow(axis, a, min(rows, n - a))
        if perm is not None:
            tile = tile.permute(*perm)
        yield a, tile.contiguous().cpu().numpy()


def _shard_tiles(x, axis: int, max_bytes: int, perm):
    """stream_global_slabs of a shard set: the whole level's tiles."""
    first = next(iter(x.shards.values()))
    lead = first.dim() - 3
    shape = tuple(first.shape[:lead]) + tuple(x.shape)
    n = shape[axis]
    row_bytes = math.prod(shape) // max(n, 1) * first.element_size()
    rows = max(1, min(n, int(max_bytes) // max(row_bytes, 1)))
    order = tuple(range(len(shape))) if perm is None else tuple(perm)
    for a in range(0, n, rows):
        m = min(rows, n - a)
        tshape = list(shape)
        tshape[axis] = m
        tile = torch.empty([tshape[i] for i in order], dtype=first.dtype)
        for k, s in x.shards.items():
            org = (0,) * lead + x.origin(k)
            lo = max(a, org[axis])
            hi = min(a + m, org[axis] + s.shape[axis])
            if lo >= hi:
                continue
            part = s.narrow(axis, lo - org[axis], hi - lo).permute(*order)
            dst = [slice(o, o + w) for o, w in zip(org, s.shape)]
            dst[axis] = slice(lo - a, hi - a)
            tile[tuple(dst[i] for i in order)] = part.cpu()
        yield a, tile.numpy()
