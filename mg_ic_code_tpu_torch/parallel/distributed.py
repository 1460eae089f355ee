"""Process bootstrap, the mesh over every process's cards, and the tile
streaming the HDF5 writers read levels through.

Port of the JAX package's `parallel/distributed.py` (the reference's
MPI_Init / MPI_Finalize role, Main_PoissonSolver.cpp:261-263, 289-291).
Where JAX runs one process per host, the port runs one process per card,
as `torchrun` starts them: `initialize()` reads torchrun's environment (or
takes the coordinator, the count and the index explicitly) and brings up
torch.distributed; `host_mesh` then lays the mesh over every process's
cards, process-major (consecutive positions on one process, so that a
slab's seams cross between processes as rarely as they can). Every
process runs the same program in the same order (parallel/mesh.py,
shards.py, transport.py say how the shards and their copies are shared).

The backend is NCCL for CUDA tensors, one process per card, and gloo only
where the caller names it (the CPU tests; one card shared by several
processes, whose tensors then cross through host memory). Nothing falls
back by itself: asked for NCCL with two processes on one card,
`initialize` raises before NCCL is built; asked for several processes
and unable to start them, it raises and never runs alone.

On one process everything is a no-op, so the same program runs on one
card and on many unchanged.
"""

from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch

from mg_ic_code_tpu_torch.parallel import mesh as pmesh

# how long a process waits for the others at start-up and at a message
TIMEOUT_S = 120.0


class SharedCardError(RuntimeError):
    """NCCL was asked for with two processes on one card."""


def _dist():
    import torch.distributed as tdist

    return tdist


def is_initialized() -> bool:
    tdist = _dist()
    return tdist.is_available() and tdist.is_initialized()


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    local_rank: int | None = None,
    timeout: float = TIMEOUT_S,
) -> None:
    """Bring up the run over several processes (idempotent; a no-op on
    one process).

    With no arguments it reads torchrun's environment: RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT (the counterpart of
    jax.distributed's auto-detection); WORLD_SIZE absent or 1 is one
    process. With `coordinator_address` ("host:port"), `num_processes`
    and `process_id` it starts through tcp:// at that address. `backend`
    None means NCCL, which needs a CUDA device; gloo only where named.
    Under NCCL the process takes card `local_rank` (LOCAL_RANK, else the
    process's index) before anything touches a card, and the processes'
    cards must be distinct. `timeout` (seconds) bounds the start-up and
    every later wait for another process. A run that was asked for and
    does not start raises."""
    if is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
        if num_processes <= 1:
            return
        process_id = int(env["RANK"])
        init_method = "env://"
    else:
        if (num_processes or 1) <= 1:
            return
        if coordinator_address is None or process_id is None:
            raise ValueError(
                "initialize: a run over several processes needs the "
                "coordinator's address, the number of processes and this "
                "process's index")
        init_method = f"tcp://{coordinator_address}"
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", process_id))
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize: NCCL needs a CUDA device; name backend='gloo' "
                "to run the processes on the CPU")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    tdist = _dist()
    try:
        tdist.init_process_group(
            backend, init_method=init_method, world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    except (RuntimeError, ValueError, TimeoutError) as e:
        raise RuntimeError(
            f"initialize: process {process_id} of {num_processes} could not "
            f"start ({backend}, {init_method}): {e}") from e
    if backend == "nccl":
        try:
            check_distinct_cards(tdist.distributed_c10d._get_default_store(),
                                 process_id, num_processes,
                                 card_uuid(local_rank), timeout)
        except SharedCardError:
            tdist.destroy_process_group()
            raise


def card_uuid(index: int) -> str:
    """The UUID of CUDA device `index` (its PCI address where this build
    of PyTorch does not give the UUID)."""
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return str(uuid)
    return ":".join(str(getattr(props, k, "?")) for k in (
        "pci_domain_id", "pci_bus_id", "pci_device_id"))


def check_distinct_cards(store, rank: int, world: int, uuid: str,
                         timeout: float = TIMEOUT_S) -> None:
    """Every process writes its card's UUID to the store and reads the
    others': raise SharedCardError where two processes hold one card
    (NCCL refuses such a group, and may hang before it says so)."""
    store.set(f"mg_ic_card_{rank}", uuid)
    keys = [f"mg_ic_card_{r}" for r in range(world)]
    store.wait(keys, datetime.timedelta(seconds=timeout))
    cards = [store.get(k).decode() for k in keys]
    shared = [r for r, c in enumerate(cards) if cards.count(c) > 1]
    if shared:
        raise SharedCardError(
            f"processes {shared} are on one card ({cards[shared[0]]}): NCCL "
            f"needs one card per process; run one process per card, or name "
            f"backend='gloo' to share a card through host memory")


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def finalize() -> None:
    """Leave the run over several processes (MPI_Finalize); a no-op on
    one process."""
    if is_initialized():
        _dist().destroy_process_group()


def agree_max(value: int) -> int:
    """The largest of every process's `value` (the exit code every
    process returns)."""
    if not is_initialized():
        return value
    got = [None] * process_count()
    _dist().all_gather_object(got, int(value))
    return max(got)


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
    """Mesh over the cards of every process, process-major: this
    process's `devices` (None: the current card where several processes
    run, else every visible card in index order) after those of the
    processes before it. With `n_cells` its 1-D-versus-pencil topology
    comes from choose_mesh_shape over all of them. Raises where there is
    no CUDA device and none is named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("host_mesh: no CUDA device available")
        devices = ([torch.device("cuda", torch.cuda.current_device())]
                   if process_count() > 1 else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    devices = [str(torch.device(d)) for d in devices]
    owners = [0] * len(devices)
    rank = process_index()
    if process_count() > 1:
        every = [None] * process_count()
        _dist().all_gather_object(every, devices)
        devices = [d for devs in every for d in devs]
        owners = [p for p, devs in enumerate(every) for _ in devs]
    n = len(devices)
    shape = (n,) if n_cells is None else choose_mesh_shape(n_cells, n)
    return pmesh.make_mesh(devices, shape, owners, rank)


def is_coordinator() -> bool:
    """Whether this process writes the files: process 0."""
    return process_index() == 0


def gather_global(x):
    """The full value of a level as host numpy on every process: a whole
    level (a tensor on any device, which every process holds, or an array
    already on the host) as it is; a level cut over the mesh gathered
    from its shards (collective: every process calls it; one level join,
    an all-gather over several processes). The writers stream tiles
    (stream_global_slabs) instead, never holding a whole level."""
    from mg_ic_code_tpu_torch.parallel.shards import ShardSet

    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, ShardSet):
        x = x.join()
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
    shard's device (permuted there), and no shard is joined on a card.

    Over several processes this is collective: every process drains the
    generator in the same order; the coordinator alone puts each tile
    together (the other processes send it their shards' parts, through
    parallel/transport.py) and receives the blocks, the others receive
    (start, None) — the writers' form without a file. A process that
    holds no part of a cut level yields nothing."""
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
    coord = is_coordinator()
    for a in range(0, n, rows):
        if not coord:
            yield a, None
            continue
        tile = x.narrow(axis, a, min(rows, n - a))
        if perm is not None:
            tile = tile.permute(*perm)
        yield a, tile.contiguous().cpu().numpy()


def _shard_tiles(x, axis: int, max_bytes: int, perm):
    """stream_global_slabs of a shard set: the whole level's tiles, put
    together by the process of position 0."""
    from mg_ic_code_tpu_torch.parallel import transport

    first = next(iter(x.shards.values()), None)
    if first is None:
        return
    lead = first.dim() - 3
    shape = tuple(first.shape[:lead]) + tuple(x.shape)
    n = shape[axis]
    row_bytes = math.prod(shape) // max(n, 1) * first.element_size()
    rows = max(1, min(n, int(max_bytes) // max(row_bytes, 1)))
    order = tuple(range(len(shape))) if perm is None else tuple(perm)
    sshape = tuple(first.shape[:lead]) + tuple(x.n_loc)
    coord = x.mesh.rank == x.mesh.owner(0)
    for a in range(0, n, rows):
        m = min(rows, n - a)
        tshape = list(shape)
        tshape[axis] = m
        tile = (torch.empty([tshape[i] for i in order], dtype=first.dtype)
                if coord else None)
        plan = []
        for k in sorted(x.pos):
            org = (0,) * lead + x.origin(k)
            lo = max(a, org[axis])
            hi = min(a + m, org[axis] + sshape[axis])
            if lo >= hi:
                continue
            dst = [slice(o, o + w) for o, w in zip(org, sshape)]
            dst[axis] = slice(lo - a, hi - a)
            dst = tuple(dst[i] for i in order)
            pshape = list(sshape)
            pshape[axis] = hi - lo
            plan.append(transport.Transfer(
                x.pos[k], 0, tuple(pshape[i] for i in order), first.dtype,
                lambda k=k, start=lo - org[axis], w=hi - lo:
                    x.shards[k].narrow(axis, start, w).permute(*order),
                lambda t, dst=dst: tile[dst].copy_(t)))
        transport.exchange(x.mesh, plan, moved=False)
        yield a, tile.numpy() if coord else None
