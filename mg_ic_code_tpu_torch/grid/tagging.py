"""AMR hierarchy generation from the regrid condition.

Dense-patch replacement for the reference's set_grids pipeline
(SetGrids.cpp:31-207): initialise temp data per level, evaluate the regrid
condition, tag cells with |condition| >= refine_threshold * max|condition|,
grow tags by 2, and build the next finer level from them — iterating until
max_level. Where Chombo runs Berger-Rigoutsos + LoadBalance to carve tag
sets into many small boxes for MPI ranks, this design emits a few LARGE
dense patches: the bounding box of every well-separated tag cluster
(`level_decomposition = patches`), or of all tags at once (`bbox`).
`device` (None = cuda) is where the regrid condition is evaluated.

Nesting: each child, coarsened to its parent's index space, is kept inside
the parent shrunk by the nesting radius (2, SetGrids.cpp:64) on faces away
from the domain boundary, and block-aligned so every level box stays
2-coarsenable (block_factor granularity, as domainSplit enforces).
"""

from __future__ import annotations

import numpy as np
import torch

from mg_ic_code_tpu_torch.config import SolverConfig
from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom, geom_from_config
from mg_ic_code_tpu_torch.physics import level_data as ld

NESTING_RADIUS = 2  # SetGrids.cpp:64
TAGS_GROW = 2  # SetGrids.cpp:109

# dense-level memory accounting: warn when a level's dense bounding box
# holds more than this multiple of the tag-union cells it actually needs
# (the price of the one-dense-box-per-level design vs Chombo's
# union-of-boxes layouts, SetGrids.cpp:54-68)
WASTE_WARN_RATIO = 4.0


def _tag_boxes(
    cond: np.ndarray, level_box: Box, thresh: float, cfg: SolverConfig
) -> list[Box]:
    """Cluster the tag set {|cond| >= thresh} into boxes with the native
    Berger-Rigoutsos builder (set_tag_cells + BRMeshRefine.regrid,
    SetGrids.cpp:108-126); boxes come back in the level's global frame."""
    mask = np.abs(cond) >= thresh
    if not mask.any():
        return []
    from mg_ic_code_tpu_torch.grid import br_native as brn

    return brn.cluster_tags(
        mask,
        fill_ratio=cfg.fill_ratio,
        max_box_size=cfg.max_grid_size,
        block_factor=max(cfg.block_factor // 2, 2),
        lo_offset=level_box.lo,
    )


def _union_bounding_box(boxes: list[Box]) -> Box:
    lo = tuple(min(b.lo[d] for b in boxes) for d in range(3))
    hi = tuple(max(b.hi[d] for b in boxes) for d in range(3))
    return Box(lo, hi)


def _shrink_for_nesting(parent: Box, domain: Box, radius: int) -> Box:
    """Parent region a child may occupy: shrink by `radius` on faces not on
    the domain boundary."""
    lo = list(parent.lo)
    hi = list(parent.hi)
    for axis in range(3):
        if parent.lo[axis] != domain.lo[axis]:
            lo[axis] += radius
        if parent.hi[axis] != domain.hi[axis]:
            hi[axis] -= radius
    if any(h < l for l, h in zip(lo, hi)):
        # a silent fall-back to the unshrunk parent would let a child sit
        # flush against a non-domain parent face, and the CF interpolation
        # would then index outside the coarse array
        raise ValueError(
            f"parent box {parent} too small for proper-nesting radius "
            f"{radius}: refine the base grid or lower max_level"
        )
    return Box(tuple(lo), tuple(hi))


def _align_cover(b: Box, block: int, bounds: Box) -> Box:
    """Block-align by GROWING (floor lo / ceil hi), then clip to `bounds`.

    Aligning inward would systematically cancel the TAGS_GROW buffer:
    Berger-Rigoutsos tag boxes come back block-granular, so ceil(lo+?-2)
    lands right back on the raw tag bbox and the coarse-fine boundary
    sits flush on the tagged high-gradient cells — the reference instead
    keeps tags GROWN by 2 when clustering (SetGrids.cpp:108-111).
    Outward alignment covers the grown tags; the clip to the
    proper-nesting region can leave edges unaligned, which is harmless
    (children are always 2-coarsenable — refine(2) gives even lo/size —
    and only the base entry carries an MG depth chain)."""
    lo, hi = [], []
    for axis in range(3):
        l = max(b.lo[axis] // block * block, bounds.lo[axis])
        h = min(-(-(b.hi[axis] + 1) // block) * block - 1, bounds.hi[axis])
        lo.append(l)
        hi.append(h)
    return Box(tuple(lo), tuple(hi))


def _regrid_condition_np(geom: HierarchyGeom, cfg: SolverConfig, level: int,
                         device=None):
    """Regrid condition on freshly-initialised data (psi = 1), as set_grids
    evaluates it on temp level data (SetGrids.cpp:86-96). Evaluated in f64
    on `device` (the only device work of hierarchy generation) and read
    back to the host."""
    fields = ld.problem_fields(geom, cfg, level, torch.float64, device)
    psi = torch.ones(
        geom.shape(level), dtype=torch.float64,
        device=fields["psi_bh"].device,
    )
    return ld.regrid_condition(psi, fields, cfg).cpu().numpy()


def _cluster_tag_boxes(tag_boxes: list[Box], sep_grow: int) -> list[list[Box]]:
    """Group tag boxes into connected clusters: boxes whose bounding
    regions grown by `sep_grow` touch belong together (transitively)."""
    clusters: list[list[Box]] = [[b] for b in tag_boxes]

    def touch(ca, cb):
        ba = _union_bounding_box(ca).grow(sep_grow)
        bb = _union_bounding_box(cb)
        return ba.intersect(bb) is not None

    merged = True
    while merged:
        merged = False
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                if touch(clusters[i], clusters[j]):
                    clusters[i] += clusters.pop(j)
                    merged = True
                    break
            if merged:
                break
    return clusters


def _gap(a: Box, b: Box) -> int:
    """Largest per-axis index gap between two boxes (0 if they overlap)."""
    g = 0
    for axis in range(3):
        if b.lo[axis] > a.hi[axis]:
            g = max(g, b.lo[axis] - a.hi[axis] - 1)
        elif a.lo[axis] > b.hi[axis]:
            g = max(g, a.lo[axis] - b.hi[axis] - 1)
    return g


def _merge_until_separated(
    cands: list[tuple[Box, int]], allowed: dict[int, Box], cap: int
) -> list[tuple[Box, int]]:
    """(box, parent) candidates at one depth: merge same-parent pairs whose
    grown(1) boxes touch (siblings must keep a >= 2-cell gap so fine ghost
    rings never overlap), then closest same-parent pairs down to `cap`.
    Candidates under different parents are separated a fortiori (parents
    are separated and nesting shrinks children inward)."""
    def merge_pair(i, j):
        bi, pi = cands[i]
        bj, _ = cands[j]
        u = _union_bounding_box([bi, bj]).intersect(allowed[pi])
        cands[i] = (u, pi)
        cands.pop(j)

    def merge_touching() -> None:
        changed = True
        while changed:
            changed = False
            for i in range(len(cands)):
                for j in range(i + 1, len(cands)):
                    if cands[i][1] == cands[j][1] and (
                        cands[i][0].grow(1).intersect(cands[j][0])
                        is not None
                    ):
                        merge_pair(i, j)
                        changed = True
                        break
                if changed:
                    break

    # every cap-merge union can engulf or abut a THIRD candidate, so the
    # separation pass must re-run after each one (not just once up front)
    merge_touching()
    while len(cands) > cap:
        best = None
        for i in range(len(cands)):
            for j in range(i + 1, len(cands)):
                if cands[i][1] != cands[j][1]:
                    continue
                g = _gap(cands[i][0], cands[j][0])
                if best is None or g < best[0]:
                    best = (g, i, j)
        if best is None:
            break  # every parent is down to one candidate
        merge_pair(best[1], best[2])
        merge_touching()
    return cands


def generate_hierarchy(cfg: SolverConfig, device=None) -> HierarchyGeom:
    """Build the hierarchy by iterative tagging (set_grids loop,
    SetGrids.cpp:70-138): each pass re-derives every depth above the base
    from the current hierarchy's regrid condition, until max_level is
    reached or no cells are tagged.

    level_decomposition = "bbox" (default): one dense bounding box per
    depth — the chain hierarchy. "patches": each well-separated tag
    cluster becomes its own dense patch entry (a forest; the dense-array
    analogue of Chombo's disjoint BRMeshRefine box layouts,
    SetGrids.cpp:108-126)."""
    patches_mode = cfg.level_decomposition == "patches"
    if cfg.level_decomposition not in ("bbox", "patches"):
        raise ValueError(
            f"bogus level_decomposition '{cfg.level_decomposition}'"
        )
    dom0 = Box.from_shape(cfg.n_cells)
    # entries as (box, parent_index, depth), parents before children
    entries: list[tuple[Box, int, int]] = [(dom0, -1, 0)]
    top = 0
    max_level = cfg.max_level
    # child boxes must stay 2-coarsenable after refinement; aligning the
    # coarse-space bounding box to block_factor/2 guarantees block_factor
    # granularity on the child
    block_c = max(cfg.block_factor // 2, 1)
    # per-depth (dense_cells, tag_union_cells) in the children's fine
    # frame, recorded on the pass that built the depth (memory accounting)
    waste: dict[int, tuple[int, int]] = {}

    while top < max_level:
        geom = geom_from_config(
            cfg,
            tuple(b for b, _, _ in entries),
            tuple(p for _, p, _ in entries),
        )
        old_at_depth: dict[int, list[int]] = {}
        for e in range(geom.num_levels):
            old_at_depth.setdefault(entries[e][2], []).append(e)
        new_entries: list[tuple[Box, int, int]] = [(dom0, -1, 0)]
        grew = False
        for d in range(0, min(top, max_level - 1) + 1):
            olds = old_at_depth.get(d, [])
            conds = {e: _regrid_condition_np(geom, cfg, e, device)
                     for e in olds}
            if not conds:
                break
            thresh = cfg.refine_threshold * max(
                float(np.max(np.abs(c))) for c in conds.values()
            )
            tag_boxes: list[Box] = []
            for e in olds:
                tag_boxes += _tag_boxes(conds[e], geom.boxes[e], thresh, cfg)
            if not tag_boxes:
                break
            new_parents = [
                i for i, (_, _, dd) in enumerate(new_entries) if dd == d
            ]
            allowed = {
                i: _shrink_for_nesting(
                    new_entries[i][0], geom.domain_boxes[olds[0]],
                    NESTING_RADIUS,
                )
                for i in new_parents
            }
            clusters = (
                _cluster_tag_boxes(tag_boxes, 2 * (TAGS_GROW + block_c))
                if patches_mode
                else [tag_boxes]
            )
            cands: list[tuple[Box, int]] = []
            for cl in clusters:
                bbox = _union_bounding_box(cl).grow(TAGS_GROW)
                for i in new_parents:
                    b = bbox.intersect(allowed[i])
                    if b is None:
                        continue
                    b = _align_cover(b, block_c, allowed[i])
                    cands.append((b, i))
            if not cands:
                break
            cands = _merge_until_separated(
                cands, allowed, cfg.max_patches if patches_mode else 1
            )
            r3 = cfg.ref_ratio ** 3
            waste[d + 1] = (
                sum(b.num_cells for b, _ in cands) * r3,
                sum(tb.num_cells for tb in tag_boxes) * r3,
            )
            for b, i in sorted(cands, key=lambda t: (t[1], t[0].lo)):
                new_entries.append((b.refine(cfg.ref_ratio), i, d + 1))
                if d + 1 > top:
                    grew = True
        entries = new_entries
        if not grew:
            break
        top = max(dd for _, _, dd in entries)

    geom = geom_from_config(
        cfg,
        tuple(b for b, _, _ in entries),
        tuple(p for _, p, _ in entries),
    )
    _report_memory_waste(geom, waste)
    return geom


def _report_memory_waste(
    geom: HierarchyGeom, waste: dict[int, tuple[int, int]]
) -> None:
    """Dense-level memory accounting: log each
    depth's dense-patch vs tag-union cell count, and WARN when the dense
    representation wastes more than WASTE_WARN_RATIO x the union — the
    signature of a config with well-separated refined regions, where
    `level_decomposition = patches` (or Chombo's union-of-boxes layout,
    SetGrids.cpp:54-68) would be materially leaner."""
    from mg_ic_code_tpu_torch.io.logging import pout

    max_d = geom.max_depth
    for depth, (dense, union) in sorted(waste.items()):
        if depth > max_d:
            continue  # depth was re-derived away on a later pass
        shapes = [
            geom.boxes[e].shape for e in geom.entries_at_depth(depth)
        ]
        ratio = dense / max(union, 1)
        msg = (
            f"depth {depth}: {len(shapes)} dense patch(es) {shapes} = "
            f"{dense:,} cells; tag union {union:,} cells ({ratio:.2f}x)"
        )
        if ratio > WASTE_WARN_RATIO:
            pout(
                "MEMORY WARNING: " + msg + " — well-separated refined "
                "regions; set level_decomposition = patches or tighten "
                "refine_threshold", level=0,
            )
        else:
            pout(msg, level=3)


def memory_report(cfg: SolverConfig, geom: HierarchyGeom,
                  device=None) -> list[dict]:
    """Per-depth memory accounting for an existing hierarchy: dense patch
    cells vs Berger-Rigoutsos tag-union cells (both in the fine frame),
    with the waste ratio. Depth 0 is always dense by construction (the
    base domain)."""
    decomp = tag_box_decomposition(cfg, geom, device=device)
    by_entry = {row["entry"]: row for row in decomp}
    out = []
    r3 = cfg.ref_ratio ** 3
    # a restarted hierarchy may be deeper than cfg.max_level (restart does
    # not cap levels); tag_box_decomposition skips entries beyond the cap,
    # so clamp the depth loop to what it actually produced
    for depth in range(1, min(geom.max_depth, cfg.max_level + 1) + 1):
        ents = geom.entries_at_depth(depth)
        dense = sum(geom.boxes[e].num_cells for e in ents)
        union = r3 * sum(
            b.num_cells
            for pe in geom.entries_at_depth(depth - 1)
            if pe in by_entry
            for b in by_entry[pe]["boxes"]
        )
        out.append({
            "level": depth,
            "patches": len(ents),
            "dense_cells": dense,
            "tag_union_cells": union,
            "waste_ratio": dense / max(union, 1),
        })
    return out


def tag_box_decomposition(
    cfg: SolverConfig, geom: HierarchyGeom, n_shards: int = 1, device=None
) -> list[dict]:
    """Diagnostic view of the Chombo-style decomposition: per entry, the
    Berger-Rigoutsos cluster boxes of the regrid tags plus a Morton
    load-balance assignment over `n_shards` — what the reference's
    BRMeshRefine + LoadBalance would have produced (SetGrids.cpp:108-126).
    The tag threshold is global per depth (set_tag_cells uses the level's
    max over all its boxes)."""
    from mg_ic_code_tpu_torch.grid import br_native as brn

    conds = {}
    thresh_by_depth = {}
    for e in range(geom.num_levels):
        d = geom.depth_of(e)
        if d > cfg.max_level:
            continue
        conds[e] = _regrid_condition_np(geom, cfg, e, device)
        m = cfg.refine_threshold * float(np.max(np.abs(conds[e])))
        thresh_by_depth[d] = max(thresh_by_depth.get(d, 0.0), m)
    out = []
    for e, cond in conds.items():
        thresh = thresh_by_depth[geom.depth_of(e)]
        boxes = _tag_boxes(cond, geom.boxes[e], thresh, cfg)
        assign = brn.load_balance(boxes, n_shards) if boxes else []
        out.append({"entry": e, "level": geom.depth_of(e),
                    "threshold": thresh, "boxes": boxes, "shard": assign})
    return out
