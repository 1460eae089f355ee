"""The one-sweep and one-pass entry points' launch rule (fused_sweeps.
sweep_geometry, sweep_blocks, sweep_segments) as pure functions, and what the
CPU path of the entry points promises.

csrc/gsrb_sweep.cu runs on the card only; what surrounds it is Python that
these tests reach: which form a call takes, the full sweep's march tile
rows and x segments, and what each march block writes and fetches
(sweep_blocks computes it as the kernel does). Every cell of `out` must be
written by exactly one block (the half sweep's stream form: by exactly one
thread), the rind rows and planes must wrap across a periodic face and stop
at any other, and a march's ring must fit the shared memory a block may
take. `capacity` stands in for the card's answer (mgk_gsrb_sweep_capacity):
blocks per multiprocessor by shared memory and threads on 132
multiprocessors.
"""

import numpy as np
import pytest
import torch

from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.ops.ghosts import (
    CF, PERIODIC, PHYS_DIRICHLET, PHYS_NEUMANN,
)

D, NM, P = PHYS_DIRICHLET, PHYS_NEUMANN, PERIODIC
KINDS = {
    "open": ((D, NM), (CF, D), (NM, CF)),
    "periodic": ((P, P),) * 3,
    "x_periodic": ((P, P), (D, CF), (NM, D)),
    "y_periodic": ((D, NM), (P, P), (CF, D)),
}
SHAPES = [(96, 80, 80), (37, 29, 45), (24, 18, 6), (4, 4, 4), (9, 7, 13),
          (256, 256, 256), (960, 144, 144), (20, 33, 10)]


def capacity(threads, smem):
    return 132 * max(1, min(2048 // threads, 233472 // (smem + 1024)))


def geometry(shape, kinds, full, itemsize=4, **kw):
    return tfs.sweep_geometry(shape, itemsize, KINDS[kinds], full, capacity,
                              **kw)


def _odd_periodic(shape, kinds):
    return any(KINDS[kinds][ax][0] == P and shape[ax] % 2
               for ax in range(3))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kinds", list(KINDS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_march_blocks_write_every_cell_once(shape, kinds, itemsize):
    if _odd_periodic(shape, kinds):
        for form in ("march", "grid", None):
            with pytest.raises(ValueError, match="odd periodic"):
                geometry(shape, kinds, True, itemsize, form=form)
        return
    nx, ny, nz = shape
    for ty in (None, 1, 3):
        g = geometry(shape, kinds, True, itemsize, form="march", ty=ty)
        assert g.form == "march" and g.threads == tfs.SWEEP_MARCH_THREADS
        assert g.ty == (ty or tfs.sweep_tile(ny, nz, itemsize))
        assert g.smem == tfs.sweep_smem(nz, g.ty, itemsize) <= tfs.SWEEP_SMEM
        # the C entry's checks: the last segment holds a plane, all cover nx
        assert (g.nseg - 1) * g.xseg < nx <= g.nseg * g.xseg
        assert g.nseg == 1 or g.xseg >= tfs.SWEEP_MIN_SEG
        blocks = tfs.sweep_blocks(shape, g, KINDS[kinds])
        assert len(blocks) == g.blocks == -(-ny // g.ty) * g.nseg
        written = np.zeros((nx, ny), dtype=int)
        for b in blocks:
            (x0, x1), (y0, y1) = b["x"], b["y"]
            assert x0 < x1 and y0 < y1
            written[x0:x1, y0:y1] += 1
        assert (written == 1).all()


@pytest.mark.parametrize("kinds", list(KINDS))
@pytest.mark.parametrize("shape", [(37, 30, 45), (9, 8, 13), (4, 4, 4),
                                   (20, 33, 10), (24, 18, 6)],
                         ids=lambda s: "x".join(map(str, s)))
def test_march_rinds_wrap_at_periodic_faces_and_stop_at_others(shape,
                                                               kinds):
    if _odd_periodic(shape, kinds):
        return
    px, py = (KINDS[kinds][ax][0] == P for ax in (0, 1))
    nx, ny, _ = shape
    for ty in (1, 2, 3):
        g = geometry(shape, kinds, True, form="march", ty=ty,
                     nseg=max(1, nx // 4))
        for b in tfs.sweep_blocks(shape, g, KINDS[kinds]):
            (x0, x1), (y0, y1) = b["x"], b["y"]

            def wrap(n, size, periodic):
                return n % size if periodic else (n if 0 <= n < size else -1)

            # two rows beyond the tile, two planes before the segment and
            # two after it; red on the segment and a plane beyond each end
            assert b["u_rows"] == [wrap(j, ny, py)
                                   for j in range(y0 - 2, y1 + 2)]
            assert b["u_planes"] == [wrap(i, nx, px)
                                     for i in range(x0 - 2, x1 + 2)]
            assert b["red_planes"] == [wrap(i, nx, px)
                                       for i in range(x0 - 1, x1 + 1)]
            # black reads post-red rows and planes one beyond its own: red
            # covers them wherever they are level cells
            red_rows = b["u_rows"][1:-1]
            for j in (y0 - 1, y1):
                if py or 0 <= j < ny:
                    assert j % ny in red_rows
            assert set(b["red_planes"]) >= set(range(x0, x1))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stream_threads_write_every_cell_once(shape):
    g = geometry(shape, "open", False)
    nx, ny, nz = shape
    assert g.form == "stream"
    chunks = -(-nz // 4)
    assert g.blocks == -(-nx * ny * chunks // tfs.SWEEP_THREADS)
    # thread m takes cells 4c .. 4c + 3 of row m // chunks (c = m % chunks)
    cover = np.zeros(nz, dtype=int)
    for c in range(chunks):
        cover[4 * c:min(4 * c + 4, nz)] += 1
    assert (cover == 1).all()
    assert g.blocks * tfs.SWEEP_THREADS >= nx * ny * chunks


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kinds", list(KINDS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forms_the_rule_picks(shape, kinds, itemsize):
    # a half sweep at an odd periodic axis is exact (out of place)
    assert geometry(shape, kinds, False, itemsize).form == "stream"
    if _odd_periodic(shape, kinds):
        with pytest.raises(ValueError, match="odd periodic"):
            geometry(shape, kinds, True, itemsize)
        return
    full = geometry(shape, kinds, True, itemsize)
    # the march where the level's four arrays overflow the L2, else the
    # grid form (gsrb_relax's)
    big = 4 * np.prod(shape) * itemsize > tfs.L2_BYTES
    assert full.form == ("march" if big else "grid")
    g = geometry(shape, kinds, True, itemsize, form="march")
    # sweep_tile's tile, and one wave of blocks (segments of at least
    # SWEEP_MIN_SEG planes)
    assert g.ty == tfs.sweep_tile(shape[1], shape[2], itemsize)
    tiles = -(-shape[1] // g.ty)
    want = max(1, min(max(shape[0] // tfs.SWEEP_MIN_SEG, 1),
                      round(capacity(g.threads, g.smem) / tiles)))
    assert g.xseg == -(-shape[0] // want)
    assert g.nseg == -(-shape[0] // g.xseg) <= want
    for full_, form in ((False, "grid"), (False, "march"), (True, "stream"),
                        (True, "wave")):
        with pytest.raises(ValueError, match="no form"):
            geometry(shape, kinds, full_, itemsize, form=form)


@pytest.mark.parametrize("ny,nz,itemsize,want", [
    (256, 256, 4, 16), (144, 144, 4, 24), (80, 80, 4, 16), (96, 96, 4, 32),
    (256, 256, 8, 4), (4, 4, 4, 4), (7, 13, 8, 8), (64, 4096, 4, None),
    (64, 8192, 8, None)])
def test_the_tile_computes_the_fewest_rows(ny, nz, itemsize, want):
    t = tfs.sweep_tile(ny, nz, itemsize)
    assert t == want
    if t is None:
        return
    smem = tfs.sweep_smem(nz, t, itemsize)
    most = (tfs.SWEEP_SMEM // 2 if smem <= tfs.SWEEP_SMEM // 2
            else tfs.SWEEP_SMEM)
    rows = -(-ny // t) * (t + 2)
    for other in tfs.SWEEP_TILE_ROWS:
        if tfs.sweep_smem(nz, other, itemsize) <= most:
            assert rows <= -(-ny // other) * (other + 2)


@pytest.mark.parametrize("nx,tiles,cap", [(96, 5, 264), (256, 16, 264),
                                          (960, 9, 264), (4, 1, 264),
                                          (37, 30, 132), (9, 2, 7)])
def test_segments_make_one_wave(nx, tiles, cap):
    nseg, xseg = tfs.sweep_segments(nx, tiles, cap)
    assert (nseg - 1) * xseg < nx <= nseg * xseg
    assert nseg == 1 or xseg >= tfs.SWEEP_MIN_SEG
    assert nseg * tiles <= 1.5 * max(cap, tiles)


@pytest.mark.parametrize("threads", [48, 1024, 0])
def test_march_threads_a_block(threads):
    with pytest.raises(ValueError, match="threads"):
        geometry((64, 32, 32), "open", True, form="march", threads=threads)
    assert geometry((64, 32, 32), "open", True, form="march",
                    threads=128).threads == 128


def test_a_march_that_does_not_fit_falls_back_or_raises():
    shape = (64, 64, 8192)  # no tile's ring fits 227 KB at f64
    assert geometry(shape, "open", True, 8).form == "grid"
    for ty in (None, 2):
        with pytest.raises(ValueError, match="no march tile"):
            geometry(shape, "open", True, 8, form="march", ty=ty)
    with pytest.raises(ValueError):
        geometry((2048, 1024, 1024), "open", True)  # 2^31 cells


@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
@pytest.mark.parametrize("entry", ["full", "half0", "half1"])
def test_plain_versions_leave_the_inputs_alone_and_count(entry, with_b):
    rng = np.random.default_rng(5)
    shape = (6, 5, 7)
    u, rhs = (torch.from_numpy(rng.standard_normal(shape)) for _ in "ur")
    a = torch.from_numpy(rng.uniform(0.5, 2.0, shape))
    b = torch.from_numpy(rng.uniform(0.5, 2.0, shape)) if with_b else None
    ins = [t.clone() for t in (u, rhs, a, b) if t is not None]
    kw = dict(kinds=((D, NM), (P, P), (CF, D)), rho=2.0, alpha=1.0,
              beta=-1.0, dx=0.3, lo=(1, 0, 0))
    name = "gsrb_full_sweep" if entry == "full" else "gsrb_half_sweep"
    kernel_counts.reset()
    if entry == "full":
        out = tfs.gsrb_full_sweep(u, rhs, a, b, **kw)
    else:
        out = tfs.gsrb_half_sweep(u, rhs, a, b, color=int(entry[-1]), **kw)
    assert kernel_counts.PLAIN_CALLS[name] == 1
    assert kernel_counts.PLAIN_CALLS["gsrb_relax"] == 0
    assert kernel_counts.LAUNCHES[name] == 0
    for t, t0 in zip((x for x in (u, rhs, a, b) if x is not None), ins):
        assert torch.equal(t, t0)
    assert out.data_ptr() != u.data_ptr()
    assert not torch.equal(out, u)


@pytest.mark.parametrize("name", ["gsrb_full_sweep", "gsrb_half_sweep"])
def test_the_kernels_line_lists_the_entry_points(name):
    import chip_smoke

    assert name in kernel_counts.KERNELS
    rows = {r["name"]: r for r in chip_smoke.kernels_line(
        None, None, None, None)["kernels"]}
    assert set(rows) == set(kernel_counts.KERNELS)
    row = rows[name]
    assert row["source"] == "mg_ic_code_tpu_torch/csrc/gsrb_sweep.cu"
    line = 266 if name == "gsrb_full_sweep" else 368
    assert row["replaces"] == f"mg_ic_code_tpu/ops/pallas_kernels.py:{line}"
    assert row["launches_of"] == "sweep_entry_points"
    assert all("pallas_kernels" not in k
               for k in rows["gsrb_relax"]["tpu_kernel"])
    # the run the line reads is a timed case where the full sweep takes its
    # march (the level overflows the L2) and the half sweep its stream
    case = {c[0]: c for c in chip_smoke.SWEEP_CASES}[chip_smoke.SWEEP_RUN_CASE]
    assert case[5] and tfs.exceeds_l2(case[1], 4)
    assert geometry(case[1], "periodic", True).form == "march"
