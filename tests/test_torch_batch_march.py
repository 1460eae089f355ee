"""gsrb_relax_batch's march form (csrc/gsrb_batch_march.cu) and the batched
wrappers' host path, on the CPU: the form rule and the launch geometry
(`fused_sweeps.gsrb_geometry`, `batch_march_geometry`), the Python constants
against the CUDA source, a plain emulation of the march's time-skewed
schedule with gsrb_relax's per-cell arithmetic (gsrb_update_row's, whose
fold the kernel makes once a plane) against the plain version, which is held
to the JAX
package's vmapped `relax_xla` (the counterpart of a batch group there), and
the errors the batched wrappers raise, reached where the check is pure
Python (`check_batch_args` on stand-in tensors). No device is needed: the
geometry is Python handed to the kernel's C entry point, and the emulation
follows the kernel's steps."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_ic_code_tpu.grid.boxes import Box as JBox
from mg_ic_code_tpu.ops import stencils as jst
from mg_ic_code_tpu.solver import multigrid as jmg

from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mg_ic_code_tpu_torch", "csrc")
CAPACITY = 132  # one block of the march (or of 512 threads) on each SM

D, C, N, P = "dirichlet", "cf", "neumann", "periodic"
ALL_C = ((C, C),) * 3


# --------------------------------------------------------------------------
# The form rule and the launch geometry


@pytest.mark.parametrize("shape,patches,kinds,form", [
    ((144,) * 3, 2, ALL_C, "march"),
    ((144,) * 3, 4, ALL_C, "march"),
    ((144,) * 3, 16, ALL_C, "march"),
    ((144, 144, 108), 3, ((D, N), (C, C), (N, D)), "march"),
    ((112,) * 3, 3, ALL_C, "serial"),
    ((112,) * 3, 3, ((P, P), (D, N), (P, P)), "serial"),
    ((144,) * 3, 2, ((C, C), (P, P), (C, C)), "serial")],
    ids=["144_pair", "144_four", "144_sixteen", "144x144x108_three",
         "112_three", "112_three_periodic", "144_pair_periodic_y"])
def test_march_where_a_group_overflows_the_l2_at_its_tile(shape, patches,
                                                           kinds, form):
    """An f32 group with constant b and 2 or 4 sweeps whose patches
    overflow the L2 that one patch's arrays fit takes the march where its
    y-z plane takes the tile width it is built for (march_tile: 44) and no
    axis is periodic, else the serial form (three 112^3 patches: width 40;
    a periodic axis); the march is asked for only where it applies, the
    serial form anywhere."""
    assert tfs.exceeds_l2((patches * shape[0],) + shape[1:], 4)
    assert not tfs.exceeds_l2(shape, 4)
    serial = tfs.gsrb_geometry(shape, 4, False, kinds, CAPACITY,
                               "grid")._replace(form="serial")
    march = tfs.batch_march_geometry(shape, kinds, CAPACITY, patches)
    assert march.tile == tfs.BATCH_MARCH_TILE
    assert march.smem == tfs.BATCH_MARCH_SMEM
    for nsweeps in tfs.BATCH_MARCH_SWEEPS:
        assert tfs.batch_takes_march(shape, 4, False, kinds, patches,
                                     nsweeps) == (form == "march")
        g = tfs.gsrb_geometry(shape, 4, False, kinds, CAPACITY,
                              patches=patches, nsweeps=nsweeps)
        assert g == (march if form == "march" else serial), nsweeps
        assert tfs.gsrb_geometry(shape, 4, False, kinds, CAPACITY, "serial",
                                 patches=patches, nsweeps=nsweeps) == serial
        if form == "march":
            assert tfs.gsrb_geometry(shape, 4, False, kinds, CAPACITY,
                                     "march", patches=patches,
                                     nsweeps=nsweeps) == march
        else:
            with pytest.raises(ValueError):
                tfs.gsrb_geometry(shape, 4, False, kinds, CAPACITY, "march",
                                  patches=patches, nsweeps=nsweeps)


def test_grid_slab_and_serial_elsewhere():
    """Groups that fit the L2 keep one patch's grid or slab form at
    capacity // P; a group that overflows it takes the serial form where
    the march does not apply (f64, variable b, other sweep counts, an odd
    periodic extent) or where asked; the march and serial forms take a
    batch only; a march asked for where it does not apply raises."""
    for shape, patches, form in (((72, 80, 80), 2, "slab"),
                                 ((104, 96, 96), 2, "slab"),
                                 ((112, 112, 112), 2, "grid"),
                                 ((48, 48, 48), 3, "grid")):
        g = tfs.gsrb_geometry(shape, 4, False, ALL_C, CAPACITY,
                              patches=patches, nsweeps=4)
        assert g.form == form, shape
        assert g == tfs.gsrb_geometry(shape, 4, False, ALL_C,
                                      CAPACITY // patches)
    pair = (144, 144, 144)
    serial = tfs.gsrb_geometry(pair, 4, False, ALL_C, CAPACITY)._replace(
        form="serial")
    for kw in (dict(nsweeps=3), dict(nsweeps=8), dict(nsweeps=None),
               dict(nsweeps=4, form="serial")):
        assert tfs.gsrb_geometry(pair, 4, False, ALL_C, CAPACITY, patches=2,
                                 **kw) == serial, kw
    # f64: one 144^3 patch overflows the L2 already (side by side, grid);
    # three 112^3 overflow it where one fits: serial
    g64 = tfs.gsrb_geometry(pair, 8, False, ALL_C, CAPACITY, patches=2,
                            nsweeps=4)
    assert g64.form == "grid"
    assert tfs.gsrb_geometry((112,) * 3, 8, False, ALL_C, CAPACITY,
                             patches=3, nsweeps=4).form == "serial"
    odd = ((P, P), (C, C), (C, C))
    assert tfs.gsrb_geometry((145, 144, 144), 4, False, odd, CAPACITY,
                             patches=2, nsweeps=4).form == "serial"
    for bad in (dict(patches=1, nsweeps=4), dict(patches=2, nsweeps=3)):
        with pytest.raises(ValueError):
            tfs.gsrb_geometry(pair, 4, False, ALL_C, CAPACITY, "march",
                              **bad)
    with pytest.raises(ValueError):
        tfs.gsrb_geometry(pair, 8, False, ALL_C, CAPACITY, "march",
                          patches=2, nsweeps=4)
    with pytest.raises(ValueError):
        tfs.gsrb_geometry(pair, 4, True, ALL_C, CAPACITY, "march",
                          patches=2, nsweeps=4)
    # asked for, the march takes a group that fits the L2 too, at its tile
    # width (16x144x144), and no other (72x80x80: width 40)
    assert tfs.gsrb_geometry((16, 144, 144), 4, False, ALL_C, CAPACITY,
                             "march", patches=2, nsweeps=2).form == "march"
    with pytest.raises(ValueError):
        tfs.gsrb_geometry((72, 80, 80), 4, False, ALL_C, CAPACITY, "march",
                          patches=2, nsweeps=2)


@pytest.mark.parametrize("capacity", [132, 100, 64, 17])
def test_march_blocks_are_the_work_items_in_rounds(capacity):
    """The march's launch: blocks over P x tiles x segments work items, as
    many as run at once (at most the capacity), in rounds; the segments
    march_segments' for all P patches' tiles (the pair at 144^3 on 132
    blocks: 4 segments of 36 planes, 128 blocks, one round)."""
    for shape, patches in (((144,) * 3, 2), ((144,) * 3, 3),
                           ((72, 144, 108), 5)):
        g = tfs.batch_march_geometry(shape, ALL_C, capacity, patches)
        inner = g.tile - 8
        tiles = patches * -(-shape[1] // inner) * -(-shape[2] // inner)
        nseg, xseg = tfs.march_segments(shape[0], tiles, capacity, 2)
        assert (g.xseg, -(-shape[0] // g.xseg)) == (xseg, nseg)
        items = tiles * nseg
        assert g.blocks == min(capacity, items) <= capacity
        rounds = -(-items // g.blocks)
        assert rounds * g.blocks >= items > (rounds - 1) * g.blocks
    g = tfs.batch_march_geometry((144,) * 3, ALL_C, 132, 2)
    assert (g.tile, g.xseg, g.blocks) == (44, 36, 128)


def test_march_constants_agree_with_the_source():
    """BATCH_MARCH_TILE is the source's tile width kW, whose shared memory
    (R planes of u and of the three coefficient arrays, R = 4 + kD + 1,
    WaveLayout's plane) is BATCH_MARCH_SMEM and fits a block's 227 KB; the
    source's kMaxBatch is BATCH_MAX, its passes a chunk two sweeps', and
    its form code in csrc/gsrb_relax.cu GSRB_FORMS'."""
    with open(os.path.join(CSRC, "gsrb_batch_march.cu")) as f:
        src = f.read()
    w = int(re.search(r"constexpr int kW = (\d+);", src).group(1))
    d = int(re.search(r"constexpr int kD = (\d+);", src).group(1))
    assert w == tfs.BATCH_MARCH_TILE
    hz = w // 2
    hp = hz + 2
    pz = 2 * hp + ((hz - 2 * hp) % 32 + 32) % 32
    smem = (4 + d + 1) * ((w + 2) * pz + 3 * w * w) * 4
    assert smem == tfs.BATCH_MARCH_SMEM <= 232448
    assert int(re.search(r"constexpr int kMaxBatch = (\d+);", src)
               .group(1)) == tfs.BATCH_MAX
    assert int(re.search(r"constexpr int kNP = (\d+);", src).group(1)) == 4
    with open(os.path.join(CSRC, "gsrb_relax.cu")) as f:
        assert int(re.search(r"FORM_MARCH = (\d+)", f.read()).group(1)) \
            == tfs.GSRB_FORMS["march"]
    assert tfs.march_tile(144, 144, 2, 4) == w


def smem_blocks(threads, smem):
    """A stand-in for the card's answer (mgk_residual_capacity): the blocks
    of `smem` bytes an H100 multiprocessor holds (228 KB, 1 KB a block
    reserved)."""
    return 233472 // (smem + 1024)


@pytest.mark.parametrize("shape,patches", [
    ((72, 80, 80), 2), ((72, 80, 80), 3), ((104, 96, 96), 2),
    ((144, 144, 144), 2), ((48, 48, 48), 3), ((112, 112, 112), 3),
    ((72, 80, 80), 1)])
def test_residual_batch_takes_the_pair_ring_where_it_fills_a_wave(
        shape, patches):
    """residual_restrict_batch's launch: segments of one plane pair, else
    of two, with a ring of RESIDUAL_PAIR_RING planes, at the lowest tile
    height whose blocks fit one wave for all the patches' tiles; where none
    does (or for one level) the rule of one patch's (segments of the wave,
    a ring of RESIDUAL_RING); the residual whole never takes the pair
    ring."""
    vz, vec = tfs.residual_form(shape[2], 4, True)
    g = tfs.residual_geometry(shape, 4, vz, vec, True, False, 132,
                              smem_blocks, patches=patches)

    def fits(ty, xseg):
        try:
            h = tfs.residual_geometry(shape, 4, vz, vec, True, False, 132,
                                      smem_blocks, ty=ty, xseg=xseg,
                                      patches=patches,
                                      ring=tfs.RESIDUAL_PAIR_RING)
        except ValueError:
            return None
        blocks = patches * h.ntiles * h.nseg
        return h if blocks <= 132 * smem_blocks(h.threads, h.smem) else None

    tys = range(2, shape[1] + 2, 2)
    first = next((fits(t, x) for x in (2, 4) for t in tys if fits(t, x)),
                 None)
    if patches > 1 and first is not None:
        assert g == first and g.ring == tfs.RESIDUAL_PAIR_RING
        assert g.xseg in (2, 4) and g.smem == g.ring * g.slot * 4
    else:
        assert g.ring == tfs.RESIDUAL_RING
        assert g == tfs.residual_geometry(shape, 4, vz, vec, True, False,
                                          132, smem_blocks, patches=patches,
                                          ring=tfs.RESIDUAL_RING)
    # the 72x80x80 pair: one plane pair a block fills one wave
    if (shape, patches) == ((72, 80, 80), 2):
        assert (g.ring, g.xseg) == (tfs.RESIDUAL_PAIR_RING, 2)
    whole = tfs.residual_geometry(shape, 4, vz, vec, False, False, 132,
                                  smem_blocks, patches=patches)
    assert whole.ring == tfs.RESIDUAL_RING
    with pytest.raises(ValueError):
        tfs.residual_geometry(shape, 4, vz, vec, False, False, 132,
                              smem_blocks, ring=tfs.RESIDUAL_PAIR_RING)
    with pytest.raises(ValueError):
        tfs.residual_geometry(shape, 4, vz, vec, True, False, 132,
                              smem_blocks, ring=3)


def test_residual_rings_agree_with_the_source():
    """The residual's ring sizes are the source's: kRing, and the restricted
    form's pair ring."""
    with open(os.path.join(CSRC, "residual.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kRing = (\d+);", src).group(1)) \
        == tfs.RESIDUAL_RING
    assert re.search(rf"ring == {tfs.RESIDUAL_PAIR_RING} && restricted", src)


# --------------------------------------------------------------------------
# The march's schedule, emulated


def face(lo, hi, c0lo, c1lo, c0hi, c1hi):
    """face_fold (csrc/gsrb_device.cuh): (wa, wb, lo, hi, c)."""
    wa = np.where(hi, 0.0, np.where(lo, 1.0 + c1lo, 1.0))
    wb = np.where(lo, 0.0, np.where(hi, 1.0 + c1hi, 1.0))
    c = np.where(lo, c0lo, 0.0) + np.where(hi, c0hi, 0.0)
    return wa, wb, lo, hi, c


def ghost(kinds, rho, ax):
    """(c0lo, c1lo, c0hi, c1hi) of an axis."""
    return tfs._ghost_lin(kinds[ax][0], rho) + tfs._ghost_lin(kinds[ax][1],
                                                              rho)


def march_block(src, rhs, a, dst, *, kinds, rho, alpha, beta, dx, base, W,
                np_, x0, x1, ty, tz, rind=True):
    """One work item of the batch march, step by step: the (ty, tz) tile of
    W x W columns (a rind of np_ on each side, the tile's neighbours read as
    0 past it, columns past a face dead: never fetched, 0) over the planes
    [xs, xe) of x segment [x0, x1) (np_ more at each open end); at step t
    pass p updates the cells of plane t - p whose (t + j + k + base) is
    even, p ascending, from the current planes (x neighbours past an open
    end: the cell itself), each by gsrb_update_row's arithmetic; then the
    tile's own cells of [x0, x1) into dst. rind = False: no planes beyond
    the segment. No axis is periodic (the kernel takes none)."""
    nx, ny, nz = src.shape
    assert all(kinds[ax][0] != P for ax in range(3))
    ti = W - 2 * np_
    b_inv = beta * (1.0 / (dx * dx))
    six_b_inv = 6.0 * b_inv
    h = np_ if rind else 0
    xs = max(0, x0 - h)
    xe = min(nx, x1 + h)
    gj = ty * ti - np_ + np.arange(W)
    gk = tz * ti - np_ + np.arange(W)
    lj = (gj >= 0) & (gj < ny)
    lk = (gk >= 0) & (gk < nz)
    live = lj[:, None] & lk[None, :]
    jx, kx = np.where(lj, gj, 0), np.where(lk, gk, 0)
    gx = ghost(kinds, rho, 0)
    fy = face(gj == 0, gj == ny - 1, *ghost(kinds, rho, 1))
    fz = face(gk == 0, gk == nz - 1, *ghost(kinds, rho, 2))
    fy = tuple(x[:, None] for x in fy)
    fz = tuple(x[None, :] for x in fz)
    U, AV, RV = [], [], []
    for q in range(xs, xe):
        take = lambda arr: np.where(live, arr[q][np.ix_(jx, kx)], 0.0)  # noqa: E731
        U.append(take(src))
        AV.append(take(a))
        RV.append(take(rhs))

    def shifted(x, ax, d):
        """x[j + d] along tile axis ax (0: y, 1: z), 0 past the tile."""
        out = np.zeros_like(x)
        if ax == 0:
            if d > 0:
                out[:-1] = x[1:]
            else:
                out[1:] = x[:-1]
        elif d > 0:
            out[:, :-1] = x[:, 1:]
        else:
            out[:, 1:] = x[:, :-1]
        return out

    for t in range(xs, xe + np_ - 1):
        colour = (t + gj[:, None] + gk[None, :] + base) % 2 == 0
        for ps in range(np_):
            q = t - ps
            if not xs <= q < xe:
                continue
            i = q - xs
            uc = U[i]
            up = [U[i + 1] if q + 1 < xe else uc, shifted(uc, 0, 1),
                  shifted(uc, 1, 1)]
            um = [U[i - 1] if q > xs else uc, shifted(uc, 0, -1),
                  shifted(uc, 1, -1)]
            folds = [face(q == 0, q == nx - 1, *gx), fy, fz]
            # gsrb_update_row: lambda, P, the c0 sum of the faces, the axes'
            # terms x, y, z, k_uc, the update
            av = AV[i]
            lam = 1.0 / (alpha * av + six_b_inv)
            Pq = lam * b_inv
            cs = 0.0
            for ax in range(3):
                cs = cs + folds[ax][4]
            nb = 0.0
            for ax in range(3):
                wa, wb, lo, hi, _ = folds[ax]
                nb = (nb + (Pq * wa) * np.where(hi, 0.0, up[ax])
                      + (Pq * wb) * np.where(lo, 0.0, um[ax]))
            k_uc = (1.0 - lam * (alpha * av)) + Pq * (cs - 6.0)
            new = (k_uc * uc + lam * RV[i]) + nb
            U[i] = np.where(colour, new, uc)
    own_j = (np.arange(W) >= np_) & (np.arange(W) < W - np_) & lj
    own_k = (np.arange(W) >= np_) & (np.arange(W) < W - np_) & lk
    for q in range(x0, x1):
        plane = U[q - xs]
        for jj in np.nonzero(own_j)[0]:
            dst[q, gj[jj], gk[own_k]] = plane[jj, own_k]


def batch_march(us, rhss, as_, *, nsweeps, kinds, rho, alpha, beta, dx, los,
                W, xseg, rind=True):
    """The batch march over a group, chunk by chunk (2 sweeps each: u ->
    tmp -> out), every work item (patch, segment, y tile, z tile) by
    march_block; a cell no item wrote stays NaN."""
    np_ = 4
    nx, ny, nz = us[0].shape
    ti = W - 2 * np_
    base = sum(los[0])
    src = [u.copy() for u in us]
    for _ in range(nsweeps // 2):
        dst = [np.full(u.shape, np.nan) for u in us]
        for k in range(len(us)):
            for x0 in range(0, nx, xseg):
                for ty in range(-(-ny // ti)):
                    for tz in range(-(-nz // ti)):
                        march_block(src[k], rhss[k], as_[k], dst[k],
                                    kinds=kinds, rho=rho, alpha=alpha,
                                    beta=beta, dx=dx, base=base, W=W,
                                    np_=np_, x0=x0, x1=min(nx, x0 + xseg),
                                    ty=ty, tz=tz, rind=rind)
        src = dst
    return src


def group(shape, npatch, seed=0):
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal(shape) for _ in range(npatch)],
            [rng.standard_normal(shape) for _ in range(npatch)],
            [rng.uniform(0.5, 2.0, shape) for _ in range(npatch)])


# (id, shape, kinds, the patches' lo, tile width, x segment): three patches
# in f64, tiles and segments small enough that a group has several of each
# (the kernel's width is 44; the schedule does not depend on W)
SCHEDULE_CASES = [
    ("open_cf_odd_parity", (10, 9, 12), ((C, C), (D, N), (C, C)),
     ((3, 4, 2), (13, 4, 2), (3, 14, 4)), 12, 4),
    ("dirichlet_neumann_odd_parity", (8, 10, 12), ((D, N), (D, C), (N, D)),
     ((1, 0, 0), (9, 0, 0), (1, 10, 2)), 12, 3),
    ("one_tile_segment_a_plane_pair", (8, 8, 6), ALL_C,
     ((1, 0, 0), (9, 0, 0), (1, 8, 0)), 12, 2),
    ("neumann_dirichlet_cf", (9, 12, 10), ((D, N), (C, C), (N, D)),
     ((0, 1, 0), (9, 1, 1), (0, 13, 0)), 10, 3),
]
KW = dict(rho=2.0, alpha=1.0, beta=-1.0, dx=0.25)


@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=[c[0] for c in SCHEDULE_CASES])
def test_march_schedule_matches_plain_and_jax(case):
    _, shape, kinds, los, W, xseg = case
    us, rhss, as_ = group(shape, len(los))
    got = batch_march(us, rhss, as_, nsweeps=4, kinds=kinds, los=los, W=W,
                      xseg=xseg, **KW)
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    ref = [r.numpy() for r in tfs.gsrb_relax_batch_plain(
        t(us), t(rhss), t(as_), nsweeps=4, kinds=kinds, los=los, **KW)]
    for g, r in zip(got, ref):
        assert not np.isnan(g).any()
        assert float(np.abs(g - r).max()) <= 1e-12 * float(np.abs(r).max())
    # the plain version against the JAX package's batch group: relax_xla
    # vmapped over the patches (one spec: the group's shape and parity)
    spec = jmg.LevelMGSpec(kinds=kinds, boxes=(JBox.from_shape(shape,
                                                               los[0]),),
                           dx=(KW["dx"],), rho=(KW["rho"],),
                           alpha=KW["alpha"], beta=KW["beta"], nsmooth=4,
                           smoother="xla")
    a = jnp.asarray(np.stack(as_))
    lam = jst.gsrb_lambda(a, KW["alpha"], KW["beta"], KW["dx"])
    jout = np.asarray(jax.vmap(
        lambda a_, l_, u_, r_: jmg.relax_xla(spec, 0, a_, l_, u_, r_, 4))(
            a, lam, jnp.asarray(np.stack(us)), jnp.asarray(np.stack(rhss))))
    for j, r in zip(jout, ref):
        np.testing.assert_allclose(r, j, rtol=0,
                                   atol=1e-12 * float(np.abs(j).max()))


def test_march_schedule_catches_a_missing_rind():
    """The emulation is not vacuous: without the planes beyond each
    segment (the rind the kernel recomputes) it disagrees."""
    _, shape, kinds, los, W, xseg = SCHEDULE_CASES[0]
    us, rhss, as_ = group(shape, len(los))
    got = batch_march(us, rhss, as_, nsweeps=2, kinds=kinds, los=los, W=W,
                      xseg=xseg, rind=False, **KW)
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    ref = tfs.gsrb_relax_batch_plain(t(us), t(rhss), t(as_), nsweeps=2,
                                     kinds=kinds, los=los, **KW)
    assert float(np.abs(got[0] - ref[0].numpy()).max()) > 1e-3 * float(
        ref[0].abs().max())


# --------------------------------------------------------------------------
# The batched wrappers' errors


class Stand:
    """What the wrappers' checks read of a tensor, settable: dtype, shape,
    device (type and index), contiguity."""

    def __init__(self, shape=(8, 10, 12), dtype=torch.float32, index=0,
                 kind="cuda", contiguous=True):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(kind, index if kind == "cuda" else None)
        self.is_cuda = kind == "cuda"
        self.ndim = len(shape)
        self._contiguous = contiguous

    def get_device(self):
        return self.device.index if self.is_cuda else -1

    def is_contiguous(self):
        return self._contiguous


def operand_lists(n=3, bad=None):
    """n patches of stand-ins; bad = {(list, patch): Stand kwargs}."""
    bad = bad or {}
    return [[Stand(**bad.get((i, k), {})) for k in range(n)]
            for i in range(3)]


# (faults, the error check_batch_args raises, a piece of its message): a
# patch whose operands disagree, a level the kernels do not take, and a
# patch whose operands agree but differ from patch 0's
BAD = [
    ({(0, 1): dict(dtype=torch.float64)}, ValueError, "operands disagree"),
    ({(1, 2): dict(dtype=torch.float64)}, ValueError, "operands disagree"),
    ({(0, 0): dict(dtype=torch.float16)}, TypeError, "not supported"),
    ({(0, 2): dict(shape=(8, 10, 14))}, ValueError, "operands disagree"),
    ({(2, 1): dict(shape=(8, 10, 14))}, ValueError, "operands disagree"),
    ({(0, 0): dict(shape=(8, 10))}, ValueError, "bad level shape"),
    ({(0, 0): dict(shape=(1, 10, 12))}, ValueError, "bad level shape"),
    ({(1, 0): dict(index=1)}, ValueError, "operands disagree"),
    ({(0, 1): dict(index=1)}, ValueError, "operands disagree"),
    ({(2, 2): dict(kind="cpu")}, ValueError, "operands disagree"),
    ({(0, 0): dict(kind="cpu")}, ValueError, "expected a CUDA tensor"),
    ({(1, 1): dict(contiguous=False)}, ValueError, "contiguous"),
    ({(0, 2): dict(contiguous=False)}, ValueError, "contiguous"),
    ({(i, 1): dict(dtype=torch.float64) for i in range(3)}, ValueError,
     "patch 1 is"),
    ({(i, 2): dict(shape=(8, 10, 14)) for i in range(3)}, ValueError,
     "patch 2 is"),
    ({(i, 1): dict(index=1) for i in range(3)}, ValueError, "patch 1 is"),
]


@pytest.mark.parametrize("bad", BAD + [({}, None, None)],
                         ids=[str(i) for i in range(len(BAD))] + ["good"])
def test_check_batch_args_raises_each_fault(bad):
    """check_batch_args raises for each fault, with its error and message
    (those of check_level_args on the patch, then of the patches' agreement:
    the checks the wrappers made before they read only cheap queries), and
    passes the good lists; gsrb_batch_launch raises the same."""
    faults, error, message = bad
    us, rhss, as_ = operand_lists(bad=faults)
    if error is None:
        tfs.check_batch_args("gsrb_relax_batch", us, rhss, as_)
        return
    with pytest.raises(error, match=message):
        tfs.check_batch_args("gsrb_relax_batch", us, rhss, as_)
    with pytest.raises(error, match=message):
        tfs.gsrb_batch_launch(us, rhss, as_, nsweeps=4, kinds=ALL_C,
                              los=[(0, 0, 0)] * 3, **KW)


def test_batched_wrappers_raise_as_before():
    """The errors reached before the card: no patch, lists of other
    lengths, a negative sweep count, the patches' parities differing
    (gsrb_relax_batch); an odd axis, an output of another shape, type or
    device (residual_restrict_batch)."""
    us, rhss, as_ = operand_lists()
    for args in (([], [], []), (us, rhss[:2], as_), (us, rhss, as_[:1])):
        with pytest.raises(ValueError):
            tfs.gsrb_batch_launch(*args, nsweeps=4, kinds=ALL_C,
                                  los=[(0, 0, 0)] * len(args[0]), **KW)
    with pytest.raises(ValueError, match="nsweeps"):
        tfs.gsrb_batch_launch(us, rhss, as_, nsweeps=-1, kinds=ALL_C,
                              los=[(0, 0, 0)] * 3, **KW)
    with pytest.raises(ValueError, match="parities"):
        tfs.gsrb_batch_launch(us, rhss, as_, nsweeps=4, kinds=ALL_C,
                              los=[(0, 0, 0), (1, 0, 0), (0, 0, 0)], **KW)
    with pytest.raises(ValueError, match="parities"):
        tfs.gsrb_batch_launch(us, rhss, as_, nsweeps=4, kinds=ALL_C,
                              los=[(0, 0, 0)] * 2, **KW)
    rng = np.random.default_rng(3)
    cpu = [torch.tensor(rng.standard_normal((8, 10, 12))) for _ in range(6)]
    with pytest.raises(ValueError, match="even"):
        tfs.residual_restrict_batch([c[:7] for c in cpu[:2]],
                                    [c[:7] for c in cpu[2:4]],
                                    [c[:7] for c in cpu[4:]], kinds=ALL_C,
                                    **KW)
    for out in (torch.zeros((4, 5, 7), dtype=torch.float64),
                torch.zeros((4, 5, 6), dtype=torch.float32),
                torch.zeros((4, 5, 6), dtype=torch.float64, device="meta")):
        with pytest.raises(ValueError, match="out"):
            tfs.residual_restrict_batch(cpu[:2], cpu[2:4], cpu[4:],
                                        kinds=ALL_C, outs=[None, out], **KW)
