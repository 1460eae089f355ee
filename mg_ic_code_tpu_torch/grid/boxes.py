"""Integer box arithmetic in level index space.

Equivalent role to Chombo's Box/ProblemDomain (used throughout the reference,
e.g. PoissonParameters.cpp:110-128, SetGrids.cpp:152-167), but each AMR level
in this framework is a SINGLE dense box — the dense-array replacement for
Chombo's union-of-small-boxes DisjointBoxLayout. `lo`/`hi` are inclusive
cell-index bounds, Chombo-style.
"""

from __future__ import annotations

import dataclasses

IVec = tuple[int, int, int]


@dataclasses.dataclass(frozen=True, order=True)
class Box:
    lo: IVec
    hi: IVec  # inclusive

    def __post_init__(self):
        if any(h < l for l, h in zip(self.lo, self.hi)):
            raise ValueError(f"empty/invalid box lo={self.lo} hi={self.hi}")

    @staticmethod
    def from_shape(shape: IVec, lo: IVec = (0, 0, 0)) -> "Box":
        return Box(tuple(lo), tuple(l + s - 1 for l, s in zip(lo, shape)))

    @property
    def shape(self) -> IVec:
        return tuple(h - l + 1 for l, h in zip(self.lo, self.hi))

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    def refine(self, r: int) -> "Box":
        return Box(
            tuple(l * r for l in self.lo),
            tuple((h + 1) * r - 1 for h in self.hi),
        )

    def coarsen(self, r: int) -> "Box":
        # floor division on both ends (Chombo coarsen semantics)
        return Box(
            tuple(l // r for l in self.lo),
            tuple(h // r for h in self.hi),
        )

    def coarsenable(self, r: int) -> bool:
        """True if coarsening by r then refining by r returns this box."""
        return self.coarsen(r).refine(r) == self

    def grow(self, n: int) -> "Box":
        return Box(tuple(l - n for l in self.lo), tuple(h + n for h in self.hi))

    def shift(self, delta: IVec) -> "Box":
        return Box(
            tuple(l + d for l, d in zip(self.lo, delta)),
            tuple(h + d for h, d in zip(self.hi, delta)),
        )

    def intersect(self, other: "Box") -> "Box | None":
        lo = tuple(max(a, b) for a, b in zip(self.lo, other.lo))
        hi = tuple(min(a, b) for a, b in zip(self.hi, other.hi))
        if any(h < l for l, h in zip(lo, hi)):
            return None
        return Box(lo, hi)

    def contains_box(self, other: "Box") -> bool:
        return all(
            sl <= ol and oh <= sh
            for sl, ol, oh, sh in zip(self.lo, other.lo, other.hi, self.hi)
        )

    def contains_point(self, iv: IVec) -> bool:
        return all(l <= i <= h for l, i, h in zip(self.lo, iv, self.hi))

    def local_slices(self, other: "Box") -> tuple[slice, slice, slice]:
        """Slices selecting `other`'s cells within an array spanning `self`."""
        if not self.contains_box(other):
            raise ValueError(f"{other} not contained in {self}")
        return tuple(
            slice(ol - sl, oh - sl + 1)
            for sl, ol, oh in zip(self.lo, other.lo, other.hi)
        )

    def align_to(self, block: int) -> "Box":
        """Smallest enclosing box whose lo/hi+1 are multiples of `block`."""
        lo = tuple((l // block) * block for l in self.lo)
        hi = tuple(-((-(h + 1)) // block) * block - 1 for h in self.hi)
        return Box(lo, hi)
