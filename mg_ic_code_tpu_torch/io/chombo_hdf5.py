"""Chombo-format HDF5 output (and a read-back loader for verification).

Produces the two files the reference writes (WriteOutput.H):

* `output_solver_data` (:52-123) — per-NL-iteration plotfile
  `vcPoissonOut.3d_<iter>.hdf5` containing dpsi, rhs and the 8 multigrid
  vars, written with WriteAMRHierarchyHDF5 schema.
* `output_final_data` (:127-227) — the GRChombo-restart checkpoint
  `vcPoissonFinal.3d.hdf5`: hand-written header (max_level, num_levels,
  regrid_interval_<l>, steps_since_regrid_<l>, num_components,
  component_<i> names) and per-level groups `level_<l>` with attributes
  ref_ratio, tag_buffer_size, dx, dt = 0.25*dx, time, prob_domain,
  is_periodic_<d>, plus the box list and cell data with 3 ghost layers.

Chombo HDF5 conventions honoured here: boxes are a compound dataset with
fields lo_i/lo_j/lo_k/hi_i/hi_j/hi_k (int); level data is one flat dataset
`data:datatype=0` holding each box's FArrayBox contiguously — components
slowest, then z, y, x fastest (Fortran order per component); the companion
`data_attributes` group records comps/objectType; `prob_domain` is a
scalar box-compound attribute. A level group holds one box per dense patch
at that depth (box-major data layout, the format's native union-of-boxes
convention).

Level data arrives as torch tensors on the solve's device, or, for a level
cut over a mesh, as parallel/shards.ShardSet: the component stacks are
made shard by shard on the shards' devices. The writers move it to the
host in z-slab tiles of at most `_STREAM_MAX_BYTES`, never as a whole
level; a cut level's tiles are put together on the host from its shards
(parallel/distributed.stream_global_slabs), the same tiles, values and
bytes as the whole level's. Over several processes the writers are
collective: every process makes the same stacks and drains the same
tiles, and the coordinator (process 0) alone opens and writes the file.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mg_ic_code_tpu_torch.config import SolverConfig
from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom
from mg_ic_code_tpu_torch.physics import level_data as ld
from mg_ic_code_tpu_torch.physics.variables import (
    GRCHOMBO_VARIABLE_NAMES,
    MULTIGRID_VARIABLE_NAMES,
    NUM_GRCHOMBO_VARS,
)

try:  # the writers need h5py; keep a clean error where it is missing
    import h5py

    HAVE_H5PY = True
except ImportError:  # pragma: no cover
    HAVE_H5PY = False


def _require_h5py():
    if not HAVE_H5PY:
        raise RuntimeError(
            "h5py is required for Chombo-format HDF5 output but is not "
            "installed"
        )


BOX_DTYPE = np.dtype(
    [
        ("lo_i", "<i4"), ("lo_j", "<i4"), ("lo_k", "<i4"),
        ("hi_i", "<i4"), ("hi_j", "<i4"), ("hi_k", "<i4"),
    ]
)


def _box_record(b: Box) -> np.void:
    return np.array(
        [(b.lo[0], b.lo[1], b.lo[2], b.hi[0], b.hi[1], b.hi[2])],
        dtype=BOX_DTYPE,
    )[0]


def _write_string_attr(obj, name: str, value: str) -> None:
    # Chombo writes fixed-length C strings
    tid = h5py.h5t.C_S1.copy()
    tid.set_size(len(value) + 1)
    obj.attrs.create(name, np.bytes_(value.encode()), dtype=h5py.Datatype(tid))


def _flatten_fab(comp_arrays: list[np.ndarray]) -> np.ndarray:
    """FArrayBox layout: component slowest, x fastest within a component.

    Our arrays are (nx, ny, nz); Fortran order (i fastest) equals C order
    of the transposed (nz, ny, nx) array."""
    flats = [np.asarray(a).ravel(order="F") for a in comp_arrays]
    return np.concatenate(flats)


def _unflatten_fab(flat: np.ndarray, shape, ncomp: int) -> list[np.ndarray]:
    n = int(np.prod(shape))
    return [
        flat[c * n : (c + 1) * n].reshape(shape, order="F")
        for c in range(ncomp)
    ]


def _write_level_group(
    f,
    level: int,
    patches: list[tuple[Box, list[np.ndarray]]],
    dx: float,
    dt: float,
    time: float,
    ref_ratio: int,
    prob_domain: Box,
    is_periodic: bool,
    ghost: int,
    tag_buffer_size: int = 3,
    ncomp: int | None = None,
) -> None:
    """One Chombo `level_<l>` group. `patches` holds every box at this
    depth with its component arrays — Chombo levels are multi-box by
    nature (the reference writes one box per <=16^3 grid chunk); the
    forest hierarchy writes one box per dense patch, box-major data
    layout (each box's FArrayBox contiguous, components slowest)."""
    g = f.create_group(f"level_{level}")
    g.attrs.create("ref_ratio", np.int32(ref_ratio))
    g.attrs.create("tag_buffer_size", np.int32(tag_buffer_size))
    g.attrs.create("dx", np.float64(dx))
    g.attrs.create("dt", np.float64(dt))
    g.attrs.create("time", np.float64(time))
    g.attrs.create("prob_domain", _box_record(prob_domain), dtype=BOX_DTYPE)
    for d in range(3):
        g.attrs.create(f"is_periodic_{d}", np.int32(1 if is_periodic else 0))

    g.create_dataset(
        "boxes",
        data=np.array([_box_record(b) for b, _ in patches], dtype=BOX_DTYPE),
    )
    if patches[0][1] is None:
        # streamed mode: preallocate the flat FArrayBox dataset; the
        # caller fills it slab-by-slab (_stream_fab_into)
        total = sum(
            ncomp * int(np.prod(b.shape)) for b, _ in patches
        )
        g.create_dataset("data:datatype=0", shape=(total,),
                         dtype=np.float64)
    else:
        ncomp = len(patches[0][1])
        g.create_dataset(
            "data:datatype=0",
            data=np.concatenate([_flatten_fab(arrs) for _, arrs in patches]),
        )

    iv_dtype = np.dtype([("intvecti", "<i4"), ("intvectj", "<i4"),
                         ("intvectk", "<i4")])
    attrs = g.create_group("data_attributes")
    attrs.attrs.create("comps", np.int32(ncomp))
    # `ghost` records the in-memory LevelData ghost vector; `outputGhost`
    # the ghost layers actually written around each box (Chombo's
    # write(LevelData) default is IntVect::Zero — valid region only,
    # WriteOutput.H:211-212)
    attrs.attrs.create(
        "ghost", np.array([(ghost, ghost, ghost)], dtype=iv_dtype)[0]
    )
    attrs.attrs.create("outputGhost", np.array([(0, 0, 0)], dtype=iv_dtype)[0])
    _write_string_attr(attrs, "objectType", "FArrayBox")


# per-tile byte bound of the streamed writers (tests shrink it to force
# genuine multi-tile streaming at toy sizes)
_STREAM_MAX_BYTES = 1 << 25


def _fab_pieces(base_off: int, cells: int, stack):
    """(offset, flat host array) pieces of one box's FArrayBox record
    (components slowest, Fortran order — i fastest — per component) in the
    flat dataset starting at `base_off`, from z-slabs of the
    (ncomp, nx, ny, nz) device stack: in Fortran order a z-slab [a, b) of
    component c is the CONTIGUOUS range
    [c*cells + nx*ny*a, c*cells + nx*ny*b), so no more than one ~32 MB tile
    is ever on the host (no full-level copy)."""
    from mg_ic_code_tpu_torch.parallel import distributed as dist
    from mg_ic_code_tpu_torch.parallel.shards import ShardSet

    # a cut level's shape is its spatial shape; a whole stack leads with
    # the components
    nx, ny = tuple(stack.shape[-3:-1]) if isinstance(stack, ShardSet) else (
        stack.shape[1], stack.shape[2])
    # z-slab tiles of at most _STREAM_MAX_BYTES; the device transposes each
    # to (ncomp, nz_tile, ny, nx) before the copy, so that on the host each
    # component of the block is already in Fortran order of (nx, ny, nz_tile)
    for z0, blk in dist.stream_global_slabs(
            stack, axis=3, max_bytes=_STREAM_MAX_BYTES, perm=(0, 3, 2, 1)):
        if blk is None:  # another process's tile: the coordinator's
            continue
        for c in range(blk.shape[0]):
            yield base_off + c * cells + nx * ny * z0, blk[c].reshape(-1)


def _stream_fab_into(dset, base_off: int, cells: int, stack) -> None:
    """Write one box's record into the flat dataset piece by piece
    (`_fab_pieces`). With `dset = None` every device operation and every
    device-to-host copy still happens and nothing is written: the form of
    every process but the coordinator, which drains the same tiles."""
    for s0, flat in _fab_pieces(base_off, cells, stack):
        if dset is not None:
            dset[s0:s0 + flat.size] = flat


@contextlib.contextmanager
def _coordinator_file(path: str):
    """The file opened for writing on the coordinator, None on every
    other process (which drains the same tiles and writes nothing)."""
    from mg_ic_code_tpu_torch.parallel import distributed as dist

    if not dist.is_coordinator():
        yield None
        return
    with h5py.File(path, "w") as f:
        yield f


SOLVER_DATA_NAMES = ["dpsi", "rhs"] + list(MULTIGRID_VARIABLE_NAMES)


def solver_data_stack(dpsi, rhs, psi, fields):
    """The plotfile's components of one box, stacked in file order:
    dpsi, rhs and the 8 multigrid vars (psi, the six A_ij, phi); a cut
    level's shard by shard."""
    from mg_ic_code_tpu_torch.parallel.shards import per_shard

    return per_shard(_solver_data_stack, dpsi, rhs, psi, fields)


def _solver_data_stack(dpsi, rhs, psi, fields):
    aij = fields["aij"]
    return torch.stack([
        dpsi, rhs, psi,
        aij[(0, 0)], aij[(0, 1)], aij[(0, 2)],
        aij[(1, 1)], aij[(1, 2)], aij[(2, 2)],
        fields["phi"],
    ])


def write_solver_data(
    path: str,
    geom: HierarchyGeom,
    cfg: SolverConfig,
    dpsi_list,
    rhs_list,
    psi_list,
    fields_list,
    iteration: int,
) -> None:
    """Plotfile with dpsi, rhs and the 8 multigrid vars per level
    (output_solver_data, WriteOutput.H:52-123; fake time = iteration).

    Memory-bounded: per-box component stacks stream to the host in
    ~32 MB z-slab tiles — no full level is ever copied at once."""
    _require_h5py()
    names = SOLVER_DATA_NAMES
    nl = geom.max_depth + 1
    with _coordinator_file(path) as f:
        if f is None:
            for d in range(nl):
                for e in geom.entries_at_depth(d):
                    _stream_fab_into(None, 0, 0, solver_data_stack(
                        dpsi_list[e], rhs_list[e], psi_list[e],
                        fields_list[e]))
            return
        f.attrs.create("num_components", np.int32(len(names)))
        f.attrs.create("num_levels", np.int32(nl))
        f.attrs.create("max_level", np.int32(nl - 1))
        f.attrs.create("iteration", np.int32(iteration))
        f.attrs.create("time", np.float64(float(iteration)))
        for i, name in enumerate(names):
            _write_string_attr(f, f"component_{i}", name)
        glob = f.create_group("Chombo_global")
        glob.attrs.create("SpaceDim", np.int32(3))
        glob.attrs.create("testReal", np.float64(0.0))

        for d in range(nl):
            ents = geom.entries_at_depth(d)
            _write_level_group(
                f, d, [(geom.boxes[e], None) for e in ents],
                dx=geom.dx[ents[0]], dt=1.0, time=float(iteration),
                ref_ratio=geom.ref_ratio,
                prob_domain=geom.domain_boxes[ents[0]],
                is_periodic=geom.bc.periodic,
                ghost=0, ncomp=len(names),
            )
            dset = f[f"level_{d}"]["data:datatype=0"]
            off = 0
            for e in ents:
                cells = int(np.prod(geom.boxes[e].shape))
                _stream_fab_into(dset, off, cells, solver_data_stack(
                    dpsi_list[e], rhs_list[e], psi_list[e], fields_list[e]))
                off += len(names) * cells


def write_final_data(
    path: str,
    geom: HierarchyGeom,
    cfg: SolverConfig,
    psi_list,
    fields_list,
    constant_K: float,
) -> None:
    """GRChombo-restart checkpoint (output_final_data, WriteOutput.H:
    127-227): 29-component state, dt = 0.25*dx, periodicity flagged true in
    every direction (GRChombo convention).

    File layout matches Chombo's write(LevelData) with its default
    outputGhost = IntVect::Zero (WriteOutput.H:211-212): the `boxes`
    dataset holds the UNGROWN valid boxes and the data stream covers the
    valid region only; the in-memory LevelData's 3-ghost allocation is
    recorded in data_attributes/ghost but not written — GRChombo's restart
    refills ghosts by exchange/interpolation.

    Memory-bounded: the 29-var stacks stream to the host in ~32 MB z-slab
    tiles (see write_solver_data / _stream_fab_into)."""
    from mg_ic_code_tpu_torch.parallel.shards import per_shard

    _require_h5py()
    nl = geom.max_depth + 1

    def stack_of(e):
        return per_shard(ld.grchombo_output_stack, psi_list[e],
                         fields_list[e], cfg, constant_K)

    with _coordinator_file(path) as f:
        if f is None:
            for d in range(nl):
                for e in geom.entries_at_depth(d):
                    _stream_fab_into(None, 0, 0, stack_of(e))
            return
        f.attrs.create("max_level", np.int32(nl - 1))
        f.attrs.create("num_levels", np.int32(nl))
        f.attrs.create("iteration", np.int32(0))
        f.attrs.create("time", np.float64(0.0))
        for l in range(nl):
            f.attrs.create(f"regrid_interval_{l}", np.int32(1))
            f.attrs.create(f"steps_since_regrid_{l}", np.int32(0))
        f.attrs.create("num_components", np.int32(NUM_GRCHOMBO_VARS))
        for i, name in enumerate(GRCHOMBO_VARIABLE_NAMES):
            _write_string_attr(f, f"component_{i}", name)
        glob = f.create_group("Chombo_global")
        glob.attrs.create("SpaceDim", np.int32(3))
        glob.attrs.create("testReal", np.float64(0.0))

        for d in range(nl):
            ents = geom.entries_at_depth(d)
            _write_level_group(
                f, d, [(geom.boxes[e], None) for e in ents],
                dx=geom.dx[ents[0]], dt=0.25 * geom.dx[ents[0]],
                time=0.0,
                ref_ratio=geom.ref_ratio,
                prob_domain=geom.domain_boxes[ents[0]],
                is_periodic=True,  # GRChombo treats it as periodic
                ghost=3,
                tag_buffer_size=cfg.buffer_size,
                ncomp=NUM_GRCHOMBO_VARS,
            )
            dset = f[f"level_{d}"]["data:datatype=0"]
            off = 0
            for e in ents:
                cells = int(np.prod(geom.boxes[e].shape))
                _stream_fab_into(dset, off, cells, stack_of(e))
                off += NUM_GRCHOMBO_VARS * cells


def _box_from_record(braw) -> Box:
    return Box(
        (int(braw["lo_i"]), int(braw["lo_j"]), int(braw["lo_k"])),
        (int(braw["hi_i"]), int(braw["hi_j"]), int(braw["hi_k"])),
    )


def read_level_patches(path: str, level: int):
    """Read back one level: (boxes, prob_domain, dx, [dict name->array]).

    Every box in the level's `boxes` dataset is returned with its own
    component dict (Chombo levels are unions of boxes; the forest
    hierarchy writes one box per patch). Boxes are the valid (ungrown)
    regions; the Chombo `outputGhost` attribute is honored, so genuine
    Chombo/GRChombo checkpoints (any written ghost width) read correctly:
    per-box data is unflattened over the outputGhost-grown box and the
    ghost rind stripped."""
    _require_h5py()
    with h5py.File(path, "r") as f:
        ncomp = int(f.attrs["num_components"])
        names = [
            f.attrs[f"component_{i}"].decode()
            if isinstance(f.attrs[f"component_{i}"], bytes)
            else str(f.attrs[f"component_{i}"])
            for i in range(ncomp)
        ]
        g = f[f"level_{level}"]
        boxes = [_box_from_record(b) for b in g["boxes"]]
        dom = _box_from_record(g.attrs["prob_domain"])
        for b in boxes:
            if not dom.contains_box(b):
                raise ValueError(
                    f"level {level} box {b} sticks out of prob_domain "
                    f"{dom}: this is the pre-round-2 legacy layout that "
                    f"stored ghost-GROWN boxes (no outputGhost attr); "
                    f"rewrite the checkpoint with the current writer"
                )
        dx = float(g.attrs["dx"])
        og = 0
        if "data_attributes" in g and "outputGhost" in g["data_attributes"].attrs:
            og = int(g["data_attributes"].attrs["outputGhost"]["intvecti"])
        flat = np.asarray(g["data:datatype=0"])
        patches = []
        off = 0
        for box in boxes:
            stored = box.grow(og) if og else box
            n = stored.num_cells * ncomp
            arrays = _unflatten_fab(flat[off:off + n], stored.shape, ncomp)
            off += n
            if og:
                arrays = [a[og:-og, og:-og, og:-og] for a in arrays]
            patches.append(dict(zip(names, arrays)))
        assert off == flat.size, (off, flat.size)
        return boxes, dom, dx, patches


def read_level_data(path: str, level: int):
    """Single-box convenience reader: (box, prob_domain, dx, dict).

    Valid only for levels written as one box (the chain hierarchy);
    multi-patch levels must use read_level_patches."""
    boxes, dom, dx, patches = read_level_patches(path, level)
    assert len(boxes) == 1, (
        f"level {level} holds {len(boxes)} boxes; use read_level_patches"
    )
    return boxes[0], dom, dx, patches[0]
