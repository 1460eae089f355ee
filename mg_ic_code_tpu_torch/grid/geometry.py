"""Hierarchy geometry: per-level boxes, spacings, domains, BC spec.

Replaces the combination of Chombo's Vector<DisjointBoxLayout> +
Vector<ProblemDomain> + Vector<RealVect> dx (reference:
Main_PoissonSolver.cpp:66-99, SetGrids.cpp:152-167). The hierarchy is a
FOREST of dense patch boxes (one entry per patch, `parent` links; the
chain default is one box per depth); geometry is static Python data
(frozen and hashable).

Index convention: arrays have shape (nx, ny, nz) with axes (x, y, z); index i
on level l is global in that level's index space. Cell centres sit at
loc = (i + 0.5) * dx - L/2 (centred coordinates, reference
SetLevelData.cpp:58-60).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mg_ic_code_tpu_torch.config import BC_DIRICHLET, BC_NEUMANN, SolverConfig
from mg_ic_code_tpu_torch.grid.boxes import Box


@dataclasses.dataclass(frozen=True)
class BCSpec:
    """Physical boundary conditions (reference: SetBCs.cpp:49-131).

    Per-direction, per-side flags: 0 = constant Dirichlet, 1 = constant
    Neumann; `periodic` overrides both (same in all directions, enforced by
    the reference at PoissonParameters.cpp:119-128).
    """

    bc_lo: tuple[int, int, int] = (0, 0, 0)
    bc_hi: tuple[int, int, int] = (0, 0, 0)
    bc_value: float = 0.0
    periodic: bool = False

    def validate(self) -> None:
        for flags in (self.bc_lo, self.bc_hi):
            for f in flags:
                if f not in (BC_DIRICHLET, BC_NEUMANN):
                    raise ValueError(f"bogus bc flag {f}")

    @staticmethod
    def from_config(cfg: SolverConfig) -> "BCSpec":
        spec = BCSpec(
            bc_lo=cfg.bc_lo,
            bc_hi=cfg.bc_hi,
            bc_value=cfg.bc_value,
            periodic=cfg.is_periodic,
        )
        if not spec.periodic:
            # fail at config time, not deep inside the first smooth
            # (periodic overrides the per-face flags, as the reference's
            # ProblemDomain periodicity does)
            spec.validate()
        return spec


@dataclasses.dataclass(frozen=True)
class HierarchyGeom:
    """Static geometry of the AMR hierarchy as a FOREST of dense patches.

    Each entry is one dense box (a "patch"); `parent[e]` gives the entry it
    refines (-1 for the base). The default `parent=None` means the chain
    (-1, 0, 1, ...) — one patch per refinement depth, the dense-bounding-box
    design. With `level_decomposition = patches` (config), well-separated
    refined regions (e.g. the two punctures of the BBH problem,
    SetGrids.cpp:108-126's disjoint Berger-Rigoutsos clusters) become
    sibling entries at the same depth: each is its own dense array, cutting
    the dense-bbox memory/compute waste (the canonical params.txt finest
    level drops ~2.5x; see tagging.memory_report). Siblings are required to be
    separated by >= 2 cells so their ghost rings never touch another
    patch's valid region — there is NO same-level patch exchange, only
    coarse-fine coupling through the parent (the role Chombo's intra-level
    Copier plays is eliminated by construction, not ported).

    Entries are ordered by non-decreasing depth and every parent precedes
    its children, so "iterate entries in reverse" visits children before
    parents (the V-cycle downsweep order).
    """

    boxes: tuple[Box, ...]  # per-entry patch box, in that depth's index space
    domain_boxes: tuple[Box, ...]  # full domain at each entry's resolution
    dx: tuple[float, ...]  # cubic cell spacing per entry
    domain_length: tuple[float, float, float]
    bc: BCSpec
    ref_ratio: int = 2
    # parent entry index per entry (-1 for the base); None = the chain
    parent: tuple[int, ...] | None = None

    def _check(self, ok: bool, msg: str) -> None:
        # explicit raise (not assert): python -O must not strip hierarchy
        # validation — restart relies on it to reject malformed checkpoints
        if not ok:
            raise ValueError(f"invalid hierarchy: {msg}")

    def __post_init__(self):
        self._check(
            len(self.boxes) == len(self.domain_boxes) == len(self.dx),
            "boxes/domain_boxes/dx length mismatch",
        )
        self._check(self.domain_boxes[0].contains_box(self.boxes[0]),
                    "base box outside the domain")
        if self.parent is None:
            object.__setattr__(
                self, "parent", (-1,) + tuple(range(self.num_levels - 1))
            )
        self._check(len(self.parent) == self.num_levels,
                    "parent length mismatch")
        self._check(self.parent[0] == -1, "entry 0 must be the base")
        for l in range(1, self.num_levels):
            # proper nesting: each entry's box must live inside its parent
            p = self.parent[l]
            self._check(0 <= p < l,
                        f"entry {l}: parent {p} must be an earlier entry")
            self._check(
                abs(self.dx[l] * self.ref_ratio - self.dx[p])
                < 1e-12 * self.dx[p],
                f"entry {l} dx {self.dx[l]} not 1/{self.ref_ratio} of "
                f"parent {p} dx {self.dx[p]}",
            )
            parent = self.boxes[p]
            pref = parent.refine(self.ref_ratio)
            self._check(
                pref.contains_box(self.boxes[l]),
                f"level {l} box {self.boxes[l]} not nested in parent "
                f"{parent}",
            )
            # nesting radius >= 1 coarse cell on every face not flush with
            # the level domain: the quadratic CF interpolation needs the
            # parent cell UNDER the fine ghost plane to exist in the parent
            # box (SetGrids.cpp:64 uses radius 2; flush faces would make
            # cf_interp index outside the coarse array)
            box, dom = self.boxes[l], self.domain_boxes[l]
            for axis in range(3):
                if box.lo[axis] != dom.lo[axis]:
                    self._check(
                        box.lo[axis] >= pref.lo[axis] + self.ref_ratio,
                        f"level {l} box {box} flush with parent {parent} "
                        f"at axis {axis} lo (non-domain face): "
                        f"proper-nesting radius >= 1 coarse cell required",
                    )
                if box.hi[axis] != dom.hi[axis]:
                    self._check(
                        box.hi[axis] <= pref.hi[axis] - self.ref_ratio,
                        f"level {l} box {box} flush with parent {parent} "
                        f"at axis {axis} hi (non-domain face): "
                        f"proper-nesting radius >= 1 coarse cell required",
                    )
        # sibling patches at the same depth: ghost rings must not touch any
        # other patch's valid cells (no same-level exchange by construction)
        by_depth: dict[float, list[int]] = {}
        for e in range(self.num_levels):
            by_depth.setdefault(self.dx[e], []).append(e)
        for entries in by_depth.values():
            for i, a in enumerate(entries):
                for b in entries[i + 1:]:
                    ga = self.boxes[a].grow(1)
                    gb = self.boxes[b].grow(1)
                    self._check(
                        ga.intersect(gb) is None,
                        f"patches {a} {self.boxes[a]} and {b} "
                        f"{self.boxes[b]} closer than 2 cells: sibling "
                        f"patches must be separated (merge their clusters)",
                    )

    @property
    def num_levels(self) -> int:
        return len(self.boxes)

    # ------------------------------------------------------------- forest
    def parent_index(self, entry: int) -> int:
        """Parent entry of `entry` (-1 for the base)."""
        return self.parent[entry]

    def children(self, entry: int) -> tuple[int, ...]:
        """Entries that refine `entry`, in index order."""
        return tuple(
            e for e in range(self.num_levels) if self.parent[e] == entry
        )

    def depth_of(self, entry: int) -> int:
        """Refinement depth of an entry (0 = base)."""
        d = 0
        while self.parent[entry] != -1:
            entry = self.parent[entry]
            d += 1
        return d

    def entries_at_depth(self, depth: int) -> tuple[int, ...]:
        return tuple(
            e for e in range(self.num_levels) if self.depth_of(e) == depth
        )

    @property
    def max_depth(self) -> int:
        return max(self.depth_of(e) for e in range(self.num_levels))

    def child_slices(self, entry: int, child: int):
        """Slices of `entry`'s array covered by `child` (coarsened)."""
        assert self.parent[child] == entry
        fine_in_crse = self.boxes[child].coarsen(self.ref_ratio)
        inter = self.boxes[entry].intersect(fine_in_crse)
        assert inter is not None
        return self.boxes[entry].local_slices(inter)

    def shape(self, level: int) -> tuple[int, int, int]:
        return self.boxes[level].shape

    # ------------------------------------------------------------------ BCs
    def face_is_physical(self, level: int, axis: int, side: int) -> bool:
        """True if the (axis, side) face of this level's box lies on the
        domain boundary (side: 0 = lo, 1 = hi). Periodic faces never count as
        physical: interior wrap / CF fill handles them."""
        if self.bc.periodic:
            return False
        box, dom = self.boxes[level], self.domain_boxes[level]
        if side == 0:
            return box.lo[axis] == dom.lo[axis]
        return box.hi[axis] == dom.hi[axis]

    def face_is_cf(self, level: int, axis: int, side: int) -> bool:
        """True if the face ghosts come from coarse-fine interpolation."""
        if level == 0:
            return False
        box, dom = self.boxes[level], self.domain_boxes[level]
        at_domain = (box.lo[axis] == dom.lo[axis]) if side == 0 else (
            box.hi[axis] == dom.hi[axis]
        )
        return not at_domain

    # ----------------------------------------------------------- coordinates
    def coords1d(self, level: int, axis: int, grow: int = 0) -> np.ndarray:
        """Centred physical coordinates of cell centres along one axis."""
        box = self.boxes[level]
        d = self.dx[level]
        idx = np.arange(box.lo[axis] - grow, box.hi[axis] + 1 + grow)
        return (idx + 0.5) * d - self.domain_length[axis] / 2.0

    def coords(self, level: int, grow: int = 0):
        """Broadcastable (x, y, z) centred coordinate arrays for the level."""
        x = self.coords1d(level, 0, grow)[:, None, None]
        y = self.coords1d(level, 1, grow)[None, :, None]
        z = self.coords1d(level, 2, grow)[None, None, :]
        return x, y, z

    # -------------------------------------------------------- covered region
    def covered_slices(self, level: int) -> tuple[slice, slice, slice] | None:
        """Slices of this entry's array covered by its (single) child.

        Needed for composite norms/sums that exclude covered cells
        (reference: computeNorm/computeSum at Main_PoissonSolver.cpp:144,208).
        For multi-child entries use `children()` + `child_slices()`; this
        chain-era helper returns the one child's region or asserts.
        """
        kids = self.children(level)
        if not kids:
            return None
        assert len(kids) == 1, (
            f"entry {level} has {len(kids)} children; use child_slices()"
        )
        return self.child_slices(level, kids[0])

    # ------------------------------------------------------------- MG depths
    def mg_depth_boxes(self, level: int, min_size: int = 4) -> tuple[Box, ...]:
        """Chain of boxes for geometric-MG depths below an AMR level.

        Depth 0 is the level box itself; each deeper entry is coarsened by 2.
        Coarsening stops when the box is no longer exactly coarsenable or any
        dimension would drop below `min_size` (Chombo stops via
        `coarsenable(coarsening * s_maxCoarse)`,
        VariableCoeffPoissonOperatorFactory.cpp:168-171).
        """
        chain = [self.boxes[level]]
        while True:
            b = chain[-1]
            if not b.coarsenable(2):
                break
            c = b.coarsen(2)
            if min(c.shape) < min_size:
                break
            chain.append(c)
        return tuple(chain)


def single_level_geom(
    n: tuple[int, int, int] | int,
    length: float | tuple[float, float, float] = 1.0,
    bc: BCSpec | None = None,
) -> HierarchyGeom:
    """Convenience: one-level hierarchy covering the whole domain."""
    if isinstance(n, int):
        n = (n, n, n)
    if isinstance(length, (int, float)):
        length = tuple(float(length) * ni / n[0] for ni in n)
    box = Box.from_shape(n)
    return HierarchyGeom(
        boxes=(box,),
        domain_boxes=(box,),
        dx=(length[0] / n[0],),
        domain_length=tuple(length),
        bc=bc if bc is not None else BCSpec(),
    )


def geom_from_config(
    cfg: SolverConfig,
    boxes: tuple[Box, ...],
    parent: tuple[int, ...] | None = None,
) -> HierarchyGeom:
    """Build a HierarchyGeom from a SolverConfig plus chosen entry boxes.

    With `parent` (forest mode) each entry's depth follows its parent
    chain; without it the boxes form the chain (one per depth)."""
    nl = len(boxes)
    dom0 = Box.from_shape(cfg.n_cells)
    if parent is None:
        depths = tuple(range(nl))
    else:
        depths_l: list[int] = []
        for e in range(nl):
            d, p = 0, parent[e]
            while p != -1:
                d += 1
                p = parent[p]
            depths_l.append(d)
        depths = tuple(depths_l)
    domain_boxes = tuple(dom0.refine(cfg.ref_ratio**d) for d in depths)
    dx = tuple(cfg.coarsest_dx / cfg.ref_ratio**d for d in depths)
    return HierarchyGeom(
        boxes=boxes,
        domain_boxes=domain_boxes,
        dx=dx,
        domain_length=cfg.domain_length,
        bc=BCSpec.from_config(cfg),
        parent=parent,
    )
