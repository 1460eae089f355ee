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

PLACEMENT GAP: every level stays whole on the mesh's first device (its
"home"). Only the smoother and the residual of a sharded depth work in
per-shard tensors on the shards' devices (parallel/halo.py), which they
cut from the whole level and join back into it per call. Keeping a
sharded level resident on its devices between calls is a later step.
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

    def device_at(self, coords: dict[str, int]) -> torch.device:
        """The device at mesh coordinates `coords` (axes left out: 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.sizes):
            c = coords.get(name, 0)
            assert 0 <= c < size, (name, c, size)
            flat = flat * size + c
        return self.devices[flat]


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
    docstring); the sharded depths cut it per smoother and residual call."""
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
