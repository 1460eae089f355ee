"""Copies of level data between mesh positions, within one process and
between processes.

Every copy that parallel/shards.py and parallel/halo.py make from one
mesh position to another goes through `exchange`. Its argument is a plan:
a list of `Transfer`s (source position, destination position, shape,
dtype) that every process derives alike and in the same order from the
layout of the shards — their counts, positions and owners, known to every
process — never from which shards it holds. A transfer whose two ends are
this process's is a plain copy; one whose ends are two processes' is a
message, and all the messages of one plan are posted together in the
plan's order as one `torch.distributed.batch_isend_irecv`, so two
processes can never wait on each other's later messages. A whole level
(`WHOLE`) is held by every process: as a source it is read where it is,
as a destination every process receives the part.

Backends: NCCL moves CUDA tensors between the processes' cards; gloo moves
host tensors, and a CUDA tensor is copied to the host before it is sent
and to its card after it arrives (the one-card check of chip_smoke.py's
`processes` phase runs so, and says so). Which one runs is what
parallel/distributed.initialize was asked for: nothing here changes it.

Counting (ops/kernel_counts.HALO): `bytes_moved` keeps its meaning, the
bytes copied between two mesh positions (a whole level counts as at
position 0), counted by the process that owns the destination (a whole
destination: process 0), so that the processes' counts add up to one
process's. `bytes_between_processes` and `messages` count what a process
received from another.

The reductions' partial sums (0-d tensors) go to every process through
`allgather_parts`, an all-gather: every process then adds the same bits in
the same order (solver/reductions.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from mg_ic_code_tpu_torch.ops import kernel_counts

WHOLE = -1


@dataclasses.dataclass(slots=True)
class Transfer:
    """One copy of a plan: the tensor `get()` (called only where `src` is
    this process's) handed to `put` (called only where `dst` is), of
    `shape` and `dtype`: what a receiving process allocates, known to
    each end (None where this process is neither end and cannot know
    them: its plan is the others' in sources and destinations)."""

    src: int
    dst: int
    shape: tuple | None
    dtype: torch.dtype | None
    get: Callable[[], torch.Tensor]
    put: Callable[[torch.Tensor], None]


def nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _here(mesh, position: int) -> bool:
    return position == WHOLE or mesh.is_local(position)


def _owner(mesh, position: int) -> int:
    return 0 if position == WHOLE else mesh.owner(position)


def comm_device() -> torch.device:
    """Where a message's tensor lives while it crosses: this process's
    card under NCCL, the host under gloo."""
    import torch.distributed as tdist

    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _moved(mesh, t: Transfer) -> None:
    """bytes_moved of one transfer, on the process that owns its
    destination."""
    if ((0 if t.src == WHOLE else t.src) != (0 if t.dst == WHOLE else t.dst)
            and _owner(mesh, t.dst) == mesh.rank):
        kernel_counts.HALO["bytes_moved"] += nbytes(t.shape, t.dtype)


def exchange(mesh, plan: list, moved: bool = True) -> None:
    """Carry out `plan` (a list of Transfer, the same on every process):
    local transfers as copies, the rest as one batch of messages in the
    plan's order. `moved`: the copies count in bytes_moved (the writers'
    tiles, which go to the coordinator's host, do not). `mesh` None: whole
    levels only, every transfer a copy here."""
    if mesh is None or mesh.nprocs == 1:  # every transfer a copy here
        count = moved and mesh is not None
        for t in plan:
            if count and (t.src if t.src != WHOLE else 0) != (
                    t.dst if t.dst != WHOLE else 0):
                kernel_counts.HALO["bytes_moved"] += nbytes(t.shape, t.dtype)
            t.put(t.get())
        return
    sends, recvs = [], []
    for i, t in enumerate(plan):
        if moved:
            _moved(mesh, t)
        src_here, dst_here = _here(mesh, t.src), _here(mesh, t.dst)
        if t.src == WHOLE:
            if dst_here:
                t.put(t.get())
            continue
        if src_here and dst_here:
            t.put(t.get())
        if src_here and (t.dst == WHOLE or not dst_here):
            peers = ([p for p in range(mesh.nprocs) if p != mesh.rank]
                     if t.dst == WHOLE else [mesh.owner(t.dst)])
            if peers:
                sends.append((i, peers, t))
        elif not src_here and dst_here:
            recvs.append((i, t))
    if not sends and not recvs:
        return
    import torch.distributed as tdist

    dev = comm_device()
    ops, bufs = [], []
    for i, peers, t in sends:
        buf = t.get().to(dev).contiguous()
        ops += [tdist.P2POp(tdist.isend, buf, p, tag=i) for p in peers]
    for i, t in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, device=dev)
        ops.append(tdist.P2POp(tdist.irecv, buf, mesh.owner(t.src), tag=i))
        bufs.append((t, buf))
    # sends and receives of one plan in ONE batch, in the plan's order on
    # every process (the order between one pair of processes is what
    # matches a receive to its send)
    ops.sort(key=lambda op: op.tag)
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    for t, buf in bufs:
        kernel_counts.HALO["bytes_between_processes"] += (
            buf.numel() * buf.element_size())
        kernel_counts.HALO["messages"] += 1
        t.put(buf)


def allgather_parts(mesh, pos: dict, parts: dict, dtype, device) -> dict:
    """{key: 0-d tensor on `device`} for every key of `pos` from each
    process's own `parts` (0-d tensors of its keys): an all-gather of the
    bits, so that every process holds the same values."""
    if mesh.nprocs == 1:
        return {k: v.to(device) for k, v in parts.items()}
    import torch.distributed as tdist

    keys = sorted(pos)
    dev = comm_device()
    mine = torch.zeros(len(keys), dtype=dtype, device=dev)
    for i, k in enumerate(keys):
        if k in parts:
            mine[i] = parts[k].to(dev)
    got = [torch.empty_like(mine) for _ in range(mesh.nprocs)]
    tdist.all_gather(got, mine)
    return {k: got[mesh.owner(pos[k])][i].to(device)
            for i, k in enumerate(keys)}

