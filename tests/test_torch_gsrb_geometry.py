"""The one-launch gsrb_relax on the CPU: its launch geometry
(`fused_sweeps.gsrb_geometry`: the form, the blocks, the slab form's tiles
of x planes and y rows and its shared memory), that the Python constants
agree with the CUDA source (csrc/gsrb_relax.cu), and a plain PyTorch
emulation of the slab form's schedule (per tile: its window of u, the
colour passes on it, the edge planes and rows out and the neighbours' in
between passes) against the plain version and the JAX package's
`resident_relax` (interpret mode, as tests/test_torch_fused_sweeps.py runs
it). No device is needed: the geometry
is plain Python handed to the kernel's C entry point, and the emulation
follows the kernel's rules step by step."""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.ops import fused_sweeps as jfs

from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mg_ic_code_tpu_torch", "csrc")
SMEM_PER_BLOCK = 232448  # bytes of shared memory one H100 block may use
CAPACITY = 132  # one block of 512 threads on each SM

D, C, N, P = "dirichlet", "cf", "neumann", "periodic"
ALL_C = ((C, C),) * 3
ALL_P = ((P, P),) * 3

# (shape, kinds, x tiles, y tiles, largest tile's planes and rows, form) at
# f32 with constant b: the 7-level path's four resident AMR levels, the
# 4-level solve's 64^3, and one block for the pencils' 8^3 P depth, a 4^3
# bottom and 16^3. The slab form where its tiles hold GSRB_SLAB_MIN_TILE
# cells or more, or one block holds the level; else the grid form.
PATH_LEVELS = [
    ((96, 80, 80), ALL_C, 16, 8, 6, 10, "grid"),
    ((128, 80, 80), ALL_C, 16, 8, 8, 10, "slab"),
    ((176, 64, 64), ALL_C, 16, 8, 11, 8, "grid"),
    ((272, 80, 80), ALL_C, 16, 8, 17, 10, "slab"),
    ((64, 64, 64), ((D, D),) * 3, 8, 16, 8, 4, "grid"),
    ((8, 8, 8), ALL_P, 1, 1, 8, 8, "slab"),
    ((4, 4, 4), ((D, D),) * 3, 1, 1, 4, 4, "slab"),
    ((16, 16, 16), ((D, N), (C, D), (N, C)), 1, 1, 16, 16, "slab"),
]


@pytest.mark.parametrize("shape,kinds,tx,ty,bx,by,form", PATH_LEVELS,
                         ids=["96x80x80", "128x80x80", "176x64x64",
                              "272x80x80", "64", "8_P", "4", "16"])
def test_path_levels_split_into_tiles(shape, kinds, tx, ty, bx, by, form):
    nx, ny, nz = shape
    assert tfs.slab_tiles(shape, 4, CAPACITY) == (tx, ty)
    g = tfs.gsrb_geometry(shape, 4, False, kinds, CAPACITY)
    assert g.form == form
    assert g.per == (1 if kinds == ALL_P else 0)
    s = tfs.gsrb_geometry(shape, 4, False, kinds, CAPACITY, form="slab")
    assert s.form == "slab" and s.blocks == tx * ty <= CAPACITY
    assert (len(s.xsplit[0]), len(s.ysplit[0])) == (tx, ty)
    assert (max(s.xsplit[1]), max(s.ysplit[1])) == (bx, by)
    assert (bx * by * nz >= tfs.GSRB_SLAB_MIN_TILE or tx * ty == 1) == (
        form == "slab")
    # the window (the tile with a plane and a row more on each side) and
    # the tile's a and rhs
    assert s.smem == ((bx + 2) * (by + 2) + 2 * bx * by) * nz * 4
    assert s.smem <= tfs.GSRB_SLAB_SMEM <= SMEM_PER_BLOCK
    for n, (first, count) in ((nx, s.xsplit), (ny, s.ysplit)):
        assert sum(count) == n
        assert first == tuple(sum(count[:k]) for k in range(len(count)))
    if form == "slab":
        assert g == s


def test_272x80x80_needs_tiles_not_planes():
    """x-slabs of whole planes over 132 blocks give some blocks 3 planes:
    their window (5 planes), a and rhs need 11 planes of 25.6 KB, more than
    a block has; tiles cut in y too fit and exchange fewer rows."""
    plane = 80 * 80 * 4
    assert (5 + 2 * 3) * plane > SMEM_PER_BLOCK
    assert tfs.tile_smem(3, 80, 80, 4) > tfs.GSRB_SLAB_SMEM
    g = tfs.gsrb_geometry((272, 80, 80), 4, False, ALL_C, CAPACITY)
    assert g.form == "slab" and len(g.ysplit[0]) > 1


@pytest.mark.parametrize("itemsize,with_b", [(8, False), (4, True),
                                             (8, True)],
                         ids=["f64", "var_b", "f64_var_b"])
def test_f64_and_variable_b_take_the_grid_form(itemsize, with_b):
    for shape in ((96, 80, 80), (272, 80, 80), (8, 8, 8)):
        g = tfs.gsrb_geometry(shape, itemsize, with_b, ALL_C, CAPACITY)
        assert g.form == "grid" and g.smem == 0
        assert g.xsplit == g.ysplit == ((), ())
        assert g.blocks == tfs.pair_grid_blocks(shape, tfs.GSRB_THREADS,
                                                CAPACITY)
        with pytest.raises(ValueError, match="no slab form"):
            tfs.gsrb_geometry(shape, itemsize, with_b, ALL_C, CAPACITY,
                              form="slab")


def test_big_levels_take_the_grid_form():
    """Levels whose tiles do not fit a block's shared memory: the grid form,
    a z pair a thread in whole x planes where that leaves at most an eighth
    of the capacity idle (512x96x96: 126 blocks of 9 planes' pairs,
    256^3: 128), else every block that runs at once (960x144x144: whole
    planes would take 81)."""
    for shape, blocks, whole in (((512, 96, 96), 126, True),
                                 ((960, 144, 144), CAPACITY, False),
                                 ((256, 256, 256), 128, True)):
        g = tfs.gsrb_geometry(shape, 4, False, ALL_C, CAPACITY)
        assert g.form == "grid" and g.blocks == blocks
        assert tfs.slab_tiles(shape, 4, CAPACITY) is None
        nx, ny, nz = shape
        plane = ny * -(-nz // 2)
        assert (g.blocks * tfs.GSRB_THREADS % plane == 0) == whole
    assert tfs.pair_grid_blocks((960, 144, 144), tfs.GSRB_THREADS,
                                CAPACITY) == 81


def test_splits_are_even_when_tiles_do_not_divide_the_level():
    """272 planes over 16 x tiles, 80 rows over 8 y tiles, and others: the
    first n % parts runs one longer, in order, with no gap or overlap."""
    for n, parts in ((272, 16), (80, 8), (97, 5), (7, 7), (1000, 1)):
        first, count = tfs.even_split(n, parts)
        assert len(first) == len(count) == parts
        assert max(count) - min(count) <= 1 and min(count) >= 1
        assert sorted(count, reverse=True) == list(count)
        assert first[0] == 0 and sum(count) == n
        assert all(first[s] + count[s] == first[s + 1]
                   for s in range(parts - 1))
    g = tfs.gsrb_geometry((272, 80, 80), 4, False, ALL_C, CAPACITY)
    assert g.xsplit[1] == (17,) * 16


def test_levels_below_the_block_count():
    """nx below the capacity: y is cut too, and no tile is empty."""
    for shape in ((40, 24, 20), (6, 40, 40), (2, 64, 48)):
        g = tfs.gsrb_geometry(shape, 4, False, ALL_C, CAPACITY, form="slab")
        tx, ty = len(g.xsplit[0]), len(g.ysplit[0])
        assert g.form == "slab" and g.blocks == tx * ty > shape[0]
        assert tx <= shape[0] and ty <= shape[1]
        assert min(g.xsplit[1]) >= 1 and min(g.ysplit[1]) >= 1


def test_slab_never_exceeds_the_budget():
    rng = np.random.default_rng(3)
    for _ in range(300):
        shape = tuple(int(n) for n in rng.integers(2, 300, 3))
        for capacity in (1, 3, CAPACITY):
            g = tfs.gsrb_geometry(shape, 4, False, ALL_C, capacity)
            assert 1 <= g.blocks <= capacity
            if tfs.slab_tiles(shape, 4, capacity) is not None:
                g = tfs.gsrb_geometry(shape, 4, False, ALL_C, capacity,
                                      form="slab")
                bx, by = max(g.xsplit[1]), max(g.ysplit[1])
                assert g.smem == tfs.tile_smem(bx, by, shape[2], 4)
                assert g.smem <= tfs.GSRB_SLAB_SMEM
                assert g.blocks <= tfs.GSRB_MAX_SLABS
                if math.prod(shape) <= tfs.GSRB_ONE_BLOCK_CELLS:
                    assert g.blocks == 1
            else:  # no split into at most `capacity` tiles fits a block
                assert g.form == "grid"
                nx, ny, nz = shape
                assert all(tfs.tile_smem(-(-nx // tx), -(-ny // ty), nz, 4)
                           > tfs.GSRB_SLAB_SMEM
                           for tx in range(1, min(nx, capacity) + 1)
                           for ty in range(1, min(ny, capacity // tx) + 1))


def test_constants_agree_with_the_source():
    with open(os.path.join(CSRC, "gsrb_relax.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == tfs.GSRB_THREADS
    assert const("kMaxSlabs") == tfs.GSRB_MAX_SLABS
    forms = dict(re.findall(r"FORM_(\w+) = (\d+)", src))
    assert {k.lower(): int(v) for k, v in forms.items()} == tfs.GSRB_FORMS


# --------------------------------------------------------------------------
# The slab schedule, emulated


SENTINEL = 1e30  # what a cell holds before anything is written to it


def slab_schedule(u, rhs, a, b, geom, *, nsweeps, kinds, rho, alpha, beta,
                  dx, lo, exchange=True):
    """The slab form of csrc/gsrb_relax.cu step by step in plain PyTorch:
    each tile's window (the tile with a plane and a row more on each side,
    corners left out) from the caller's u, wrapped along periodic axes;
    each colour pass on the tile's window alone; along a cut axis the
    tile's first and last planes (x) or rows (y) out to `out`, then the
    neighbours' into each window; along a whole periodic axis the tile's
    own far plane or row into its halo; at the end every tile out. A window
    cell the kernel never loads, and a cell of `out` that no tile wrote,
    hold SENTINEL: reading one spoils the result. exchange = False leaves
    the steps between passes out."""
    nx, ny, nz = u.shape
    xper, yper = kinds[0][0] == P, kinds[1][0] == P
    kw = dict(kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx, lo=lo)
    tx, ty = len(geom.xsplit[0]), len(geom.ysplit[0])
    out = torch.full(u.shape, SENTINEL, dtype=u.dtype)
    ii, jj, kk = torch.meshgrid(torch.arange(nx), torch.arange(ny),
                                torch.arange(nz), indexing="ij")

    def beyond(i, n, periodic):
        return i if 0 <= i < n else (i % n if periodic else None)

    tiles = []
    for ix in range(tx):
        for iy in range(ty):
            i0, bx = geom.xsplit[0][ix], geom.xsplit[1][ix]
            j0, by = geom.ysplit[0][iy], geom.ysplit[1][iy]
            gi = [beyond(i0 - 1 + li, nx, xper) for li in range(bx + 2)]
            gj = [beyond(j0 - 1 + lj, ny, yper) for lj in range(by + 2)]
            win = torch.full((bx + 2, by + 2, nz), SENTINEL, dtype=u.dtype)
            halo = [(li, lj) for li in range(bx + 2) for lj in range(by + 2)
                    if (li in (0, bx + 1)) != (lj in (0, by + 1))]
            for li, lj in halo:
                if gi[li] is not None and gj[lj] is not None:
                    win[li, lj] = u[gi[li], gj[lj]]
            win[1:bx + 1, 1:by + 1] = u[i0:i0 + bx, j0:j0 + by]
            tiles.append(dict(i0=i0, bx=bx, j0=j0, by=by, gi=gi, gj=gj,
                              win=win, halo=halo))
    npass = 2 * nsweeps
    for p in range(npass):
        colour = ((ii + jj + kk + sum(lo) + p) % 2) == 0
        for t in tiles:
            i0, bx, j0, by, win = t["i0"], t["bx"], t["j0"], t["by"], t["win"]
            state = torch.full(u.shape, SENTINEL, dtype=u.dtype)
            for li, lj in t["halo"]:
                if t["gi"][li] is not None and t["gj"][lj] is not None:
                    state[t["gi"][li], t["gj"][lj]] = win[li, lj]
            state[i0:i0 + bx, j0:j0 + by] = win[1:bx + 1, 1:by + 1]
            new = tfs.gsrb_sweeps_folded(state, rhs, a, b, nsweeps=1,
                                         colors=(p,), **kw)
            own = (slice(i0, i0 + bx), slice(j0, j0 + by))
            win[1:bx + 1, 1:by + 1] = torch.where(
                colour[own], new[own], win[1:bx + 1, 1:by + 1])
        if p + 1 == npass or not exchange:
            continue
        for t in tiles:
            i0, bx, j0, by, win = t["i0"], t["bx"], t["j0"], t["by"], t["win"]
            if tx > 1:
                out[i0, j0:j0 + by] = win[1, 1:by + 1]
                out[i0 + bx - 1, j0:j0 + by] = win[bx, 1:by + 1]
            if ty > 1:
                out[i0:i0 + bx, j0] = win[1:bx + 1, 1]
                out[i0:i0 + bx, j0 + by - 1] = win[1:bx + 1, by]
        for t in tiles:
            i0, bx, j0, by, win = t["i0"], t["bx"], t["j0"], t["by"], t["win"]
            if tx == 1 and xper:
                win[0, 1:by + 1] = win[bx, 1:by + 1]
                win[bx + 1, 1:by + 1] = win[1, 1:by + 1]
            if ty == 1 and yper:
                win[1:bx + 1, 0] = win[1:bx + 1, by]
                win[1:bx + 1, by + 1] = win[1:bx + 1, 1]
            if tx > 1:
                for li in (0, bx + 1):
                    if t["gi"][li] is not None:
                        win[li, 1:by + 1] = out[t["gi"][li], j0:j0 + by]
            if ty > 1:
                for lj in (0, by + 1):
                    if t["gj"][lj] is not None:
                        win[1:bx + 1, lj] = out[i0:i0 + bx, t["gj"][lj]]
    for t in tiles:
        i0, bx, j0, by = t["i0"], t["bx"], t["j0"], t["by"]
        out[i0:i0 + bx, j0:j0 + by] = t["win"][1:bx + 1, 1:by + 1]
    return out


def slab_split(shape, tx, ty):
    """The slab form's launch over tx x ty tiles."""
    return tfs.GsrbGeometry("slab", 0, tx * ty, tfs.even_split(shape[0], tx),
                            tfs.even_split(shape[1], ty), 0)


def fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "u": rng.standard_normal(shape),
        "rhs": rng.standard_normal(shape),
        "a": rng.uniform(0.5, 2.0, shape),
        "b": rng.uniform(0.5, 2.0, shape),
    }


# (id, shape, kinds, lo, with_b, x tiles, y tiles): the level cut by the
# slab form's rule (even_split) over the tiles given (gsrb_geometry takes
# levels this small as one block); the sweeps run in f64, with b where asked
# (the schedule does not depend on it)
SCHEDULE_CASES = [
    ("odd_lo", (12, 10, 8), ALL_C, (3, 4, 2), False, 3, 2),
    ("x_periodic_3_slabs", (9, 6, 10), ((P, P), (D, C), (C, N)), (0, 5, 0),
     False, 3, 1),
    ("x_periodic_2_tiles", (6, 9, 8), ((P, P), (C, N), (D, D)), (1, 0, 0),
     False, 2, 3),
    ("y_periodic_whole", (10, 6, 8), ((D, N), (P, P), (C, C)), (0, 1, 0),
     False, 4, 1),
    ("mixed_faces_b", (10, 8, 12), ((D, N), (C, D), (N, C)), (2, 0, 1), True,
     2, 2),
    ("all_periodic_thin", (4, 6, 8), ALL_P, (0, 1, 0), False, 4, 3),
    ("one_block_periodic", (6, 8, 10), ((P, P), (P, P), (N, N)), (0, 0, 1),
     False, 1, 1),
]


@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=[c[0] for c in SCHEDULE_CASES])
def test_slab_schedule_matches_plain_and_jax(case):
    _, shape, kinds, lo, with_b, tx, ty = case
    geom = slab_split(shape, tx, ty)
    f = fields(shape)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    b = t["b"] if with_b else None
    kw = dict(nsweeps=4, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25,
              lo=lo)
    out = slab_schedule(t["u"], t["rhs"], t["a"], b, geom, **kw)
    ref = tfs.gsrb_relax_plain(t["u"], t["rhs"], t["a"], b, **kw)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-12 * scale
    jref = np.asarray(jfs.resident_relax(
        jnp.asarray(f["u"]), jnp.asarray(f["rhs"]), jnp.asarray(f["a"]),
        jnp.asarray(f["b"]) if with_b else None, interpret=True, **kw))
    np.testing.assert_allclose(out.numpy(), jref, rtol=0, atol=1e-12 * scale)


def test_schedule_catches_a_missing_exchange():
    """The emulation is not vacuous: with the rows between passes left out
    (each window keeps the caller's u beyond its block) it disagrees."""
    shape, kinds, lo = (12, 10, 8), ALL_C, (3, 4, 2)
    geom = slab_split(shape, 3, 2)
    t = {k: torch.from_numpy(v) for k, v in fields(shape).items()}
    kw = dict(nsweeps=2, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25,
              lo=lo)
    ref = tfs.gsrb_relax_plain(t["u"], t["rhs"], t["a"], None, **kw)
    out = slab_schedule(t["u"], t["rhs"], t["a"], None, geom, exchange=False,
                        **kw)
    assert float((out - ref).abs().max()) > 1e-3 * float(ref.abs().max())
