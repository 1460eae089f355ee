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

PLACEMENT GAP: the preconditioner keeps every depth the mesh cuts on its
shards (parallel/shards.ShardSet) from the moment a V-cycle takes it up:
the smoother, the residual and its restriction, the prolongation and the
post-smooth work shard by shard and exchange only pads, and the
coefficients are cut and padded once per coefficient build
(parallel/halo.shard_coefs). What stays whole on the mesh's first device
(its "home") is the rest of the solve, as shard_level_list places it: the
Krylov vectors, the composite operator with its coarse-fine term, the
Picard state (prepare_iteration / finish_iteration) and the file writers.
So a cut level is split once a V-cycle where the V-cycle takes up its
residual (and its coarse correction and folded rhs) and its correction is
joined once; keeping those resident too is the next step.
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
    repeat). `shape` maps each axis name to its size, as a JAX mesh's."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        assert len(self.axis_names) == len(self.sizes)
        assert math.prod(self.sizes) == len(self.devices), (
            self.sizes, len(self.devices))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The device whole levels live on (the mesh's first)."""
        return self.devices[0]

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


def make_mesh(devices=None, shape: tuple[int, ...] | None = None) -> Mesh:
    """Device mesh: 1-D over x-slabs by default, 2-D (x, y) pencils or 3-D
    (x, y, z) blocks when `shape` has two or three entries. `devices` None
    means every visible CUDA device, in index order, and raises where there
    is none; the CPU is used only when the caller names CPU devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device available (name the devices, "
                "e.g. ['cpu'] * 8, to build a mesh elsewhere)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if shape is None or len(shape) == 1:
        return Mesh(devices, (AXIS,), (len(devices),))
    assert len(shape) in (2, 3) and math.prod(shape) == len(devices)
    return Mesh(devices, AXES[: len(shape)], tuple(int(s) for s in shape))


def patch_axis(mesh: Mesh, nparts: int) -> str | None:
    """Mesh axis to spread a stacked sibling-patch axis over: prefer y
    (keeping x free for interior slab sharding); the axis size must divide
    the patch count. None = no usable axis. The JAX package's forest
    batching asks it; no path of the port does yet (forest batching is not
    ported): tests/test_torch_parallel.py holds it to the JAX decision."""
    for name in (AXIS_Y, AXIS):
        sz = mesh.shape.get(name, 1)
        if sz > 1 and nparts % sz == 0:
            return name
    return None


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


def shard_level_list(u_list, mesh: Mesh):
    """Place every level array for a solve on `mesh`. Each level goes
    whole to the mesh's home device (the placement gap of the module
    docstring); the preconditioner cuts the levels the mesh cuts once a
    V-cycle and keeps them on their shards inside it."""
    return [u.to(mesh.home) for u in u_list]


def shard_fields(fields_list, mesh: Mesh):
    """Place the static physics fields (a dict per level) like the state."""
    put = lambda a: a.to(mesh.home)  # noqa: E731
    return [
        {k: ({kk: put(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else put(v))
         for k, v in fields.items()}
        for fields in fields_list
    ]
