"""Device mesh and level-array sharding policy.

Port of the JAX package's `parallel/mesh.py`: the replacement for the
reference's MPI domain decomposition (LoadBalance box->rank assignment,
SetGrids.cpp:57,126). A mesh is a tuple of devices laid out over the axes
("x",), ("x", "y") or ("x", "y", "z"); a level array is cut along each
array axis whose mesh axis divides it evenly into shards of at least
MIN_LOCAL_NX cells. Levels too small to shard stay whole.

One device may appear in a mesh more than once. A mesh that names
`cuda:0` four times cuts a level into four shards on one card: the seams,
the halo exchange between them and the global checkerboard are then
exactly those of four cards, which is how one card drives the sharded
path (and how the CPU tests name eight `cpu` entries).

PLACEMENT: as the JAX package places every level that level_spec cuts
on its devices for the whole solve, shard_level_list / shard_fields hold
every level the mesh cuts as a parallel/shards.ShardSet from the solve's
placement to its end: the state and the physics fields, aCoef and rhs,
every Krylov vector and the preconditioner's input and output. The
composite operator with its coarse-fine term, the reductions, the Picard
state's updates and the file writers' tiles work shard by shard. What
stays whole on the mesh's first device (its "home") is every level the
mesh does not cut (the JAX package's replicated levels), the depths of
the depth chain below the last cut one, the 0-d scalars (Krylov
coefficients, norms, K) and the solve's result, which poisson_solve joins
once at its end. Between mesh positions cross only the pads and ghost
planes of the shards' exchanges, the level windows (the part of one cut
level that another level's shards read or write) and the depth chain's
reshards (parallel/shards.py counts each).

PROCESSES: a mesh may span several processes (parallel/distributed.py,
one process per card): every position has an owning process, positions
are process-major (a process's positions are consecutive, the first
process's first), and every process holds the same Mesh with its own
`rank`. A process makes and keeps only the shards at its own positions
(its ShardSets hold those alone, the layout of the others is known
everywhere), and `home` is its first position's device: the levels the
mesh does not cut are whole on every process's home, and every process
computes them, as the JAX package's replicated levels. What crosses
between processes goes through parallel/transport.py. A mesh of one
process (every position owned by process 0) is the single-process mesh.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom

AXIS = "x"
AXIS_Y = "y"
AXIS_Z = "z"
AXES = (AXIS, AXIS_Y, AXIS_Z)

# below this many cells per device along an axis, sharding a level costs
# more in halo traffic than it saves in compute: keep the axis whole
MIN_LOCAL_NX = 8


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in row-major order over the named axes (one device may
    repeat). `shape` maps each axis name to its size, as a JAX mesh's.
    `owners[p]` is the process that owns position p (empty: process 0
    owns every position) and `rank` the process holding this Mesh; a
    device of another process's position is that process's name for it."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    owners: tuple[int, ...] = ()
    rank: int = 0

    def __post_init__(self):
        assert len(self.axis_names) == len(self.sizes)
        assert math.prod(self.sizes) == len(self.devices), (
            self.sizes, len(self.devices))
        if not self.owners:
            object.__setattr__(self, "owners", (0,) * len(self.devices))
        owners = list(self.owners)
        if (len(owners) != len(self.devices) or owners != sorted(owners)
                or sorted(set(owners)) != list(range(owners[-1] + 1))
                or self.rank not in owners):
            raise ValueError(
                f"mesh: the owners {owners} of {len(self.devices)} positions "
                f"must be processes 0, 1, ... in process-major order, "
                f"process {self.rank} among them")

    @property
    def nprocs(self) -> int:
        return self.owners[-1] + 1

    def owner(self, position: int) -> int:
        """The process that owns mesh position `position`."""
        return self.owners[position]

    def is_local(self, position: int) -> bool:
        """Whether `position` is this process's."""
        return self.owners[position] == self.rank

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home_position(self) -> int:
        """This process's first position."""
        return self.owners.index(self.rank)

    @property
    def home(self) -> torch.device:
        """The device whole levels live on: this process's first (on one
        process the mesh's first)."""
        return self.devices[self.home_position]

    def position_at(self, coords: dict[str, int]) -> int:
        """The flat (row-major) position of mesh coordinates `coords`
        (axes left out: 0); the home is position 0."""
        flat = 0
        for name, size in zip(self.axis_names, self.sizes):
            c = coords.get(name, 0)
            assert 0 <= c < size, (name, c, size)
            flat = flat * size + c
        return flat

    def device_at(self, coords: dict[str, int]) -> torch.device:
        """The device at mesh coordinates `coords` (axes left out: 0)."""
        return self.devices[self.position_at(coords)]


def make_mesh(devices=None, shape: tuple[int, ...] | None = None,
              owners=(), rank: int = 0) -> Mesh:
    """Device mesh: 1-D over x-slabs by default, 2-D (x, y) pencils or 3-D
    (x, y, z) blocks when `shape` has two or three entries. `devices` None
    means every visible CUDA device, in index order, and raises where there
    is none; the CPU is used only when the caller names CPU devices.
    `owners` and `rank`: the positions' processes and this one's (Mesh);
    distributed.host_mesh gives them over several processes."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device available (name the devices, "
                "e.g. ['cpu'] * 8, to build a mesh elsewhere)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    owners = tuple(owners)
    if shape is None or len(shape) == 1:
        return Mesh(devices, (AXIS,), (len(devices),), owners, rank)
    assert len(shape) in (2, 3) and math.prod(shape) == len(devices)
    return Mesh(devices, AXES[: len(shape)], tuple(int(s) for s in shape),
                owners, rank)


def patch_axis(mesh: Mesh, nparts: int) -> str | None:
    """Mesh axis to spread a stacked sibling-patch axis over: prefer y
    (keeping x free for interior slab sharding); the axis size must divide
    the patch count. None = no usable axis. tests/test_torch_parallel.py
    holds it to the JAX decision."""
    for name in (AXIS_Y, AXIS):
        sz = mesh.shape.get(name, 1)
        if sz > 1 and nparts % sz == 0:
            return name
    return None


def patch_positions(mesh: Mesh, nparts: int) -> tuple[int, ...] | None:
    """The mesh position of each of `nparts` sibling patches batched
    together (solver/composite.py's batch groups), the counterpart of the
    JAX package's `_stack_patches`: with patch_axis(mesh, nparts) = name,
    the patches cut in order into as many chunks as that axis has
    positions, chunk k at coordinate k of the axis and 0 along the others
    (the port keeps uncut levels whole on one position, its reading of the
    JAX package's replicated levels). None where no axis is usable: the
    group then runs whole on the home."""
    name = patch_axis(mesh, nparts)
    if name is None:
        return None
    per = nparts // mesh.shape[name]
    return tuple(mesh.position_at({name: i // per}) for i in range(nparts))


def shard_counts(mesh: Mesh, shape) -> tuple[int, int, int]:
    """Per array axis of an array of `shape`, the number of shards it is
    cut into: its mesh axis's size where that divides the extent evenly
    into shards of at least MIN_LOCAL_NX cells, else 1 (the axis stays
    whole). The one sharding rule: level_spec names it per level,
    multigrid._shard_counts applies it per depth."""
    counts = []
    for array_axis, name in enumerate(AXES):
        ndev = mesh.shape.get(name, 1)
        n = shape[array_axis]
        ok = ndev > 1 and n % ndev == 0 and n // ndev >= MIN_LOCAL_NX
        counts.append(ndev if ok else 1)
    return tuple(counts)


def level_spec(
    geom: HierarchyGeom, level: int, mesh: Mesh
) -> tuple[str | None, str | None, str | None]:
    """Per array axis, the mesh axis it is cut over or None (the JAX
    package's PartitionSpec for the level; shard_counts' rule)."""
    counts = shard_counts(mesh, geom.shape(level))
    return tuple(name if c > 1 else None for name, c in zip(AXES, counts))


def place(u: torch.Tensor, mesh: Mesh, lo=(0, 0, 0)):
    """One level array as the solve holds it on `mesh`: cut into its
    shards on their devices where shard_counts cuts it (one level split),
    else whole on the home."""
    from mg_ic_code_tpu_torch.parallel.shards import ShardSet

    counts = shard_counts(mesh, tuple(u.shape))
    if counts == (1, 1, 1):
        return u.to(mesh.home)
    return ShardSet.split(u, mesh, counts, lo)


def shard_level_list(u_list, mesh: Mesh, geom: HierarchyGeom | None = None):
    """Place every level array for a solve on `mesh` (`place`): the levels
    the mesh cuts as shard sets, the rest whole on the home. `geom` gives
    the shard sets their levels' lo."""
    return [place(u, mesh, (0, 0, 0) if geom is None else geom.boxes[l].lo)
            for l, u in enumerate(u_list)]


def shard_fields(fields_list, mesh: Mesh, geom: HierarchyGeom | None = None):
    """Place the static physics fields (a dict per level) like the state."""
    out = []
    for l, fields in enumerate(fields_list):
        lo = (0, 0, 0) if geom is None else geom.boxes[l].lo
        put = lambda a: place(a, mesh, lo)  # noqa: E731
        out.append({k: ({kk: put(vv) for kk, vv in v.items()}
                        if isinstance(v, dict) else put(v))
                    for k, v in fields.items()})
    return out
