"""On a CUDA device: the hand-written kernels against their plain PyTorch
versions, through the public wrappers. Skipped where there is no device.

This file imports only torch and the port, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest \
        -o addopts="" -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mg_ic_code_tpu_torch.grid.geometry import BCSpec, single_level_geom  # noqa: E402
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs  # noqa: E402
from mg_ic_code_tpu_torch.ops import kernel_counts  # noqa: E402
from mg_ic_code_tpu_torch.solver import multigrid as tmg  # noqa: E402

D, C, N = "dirichlet", "cf", "neumann"
KINDS = ((D, N), (C, D), (N, C))
DTYPES = {"f32": (np.float32, 2e-5), "f64": (np.float64, 1e-12)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")


def fields(shape, npdt, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "u": rng.standard_normal(shape).astype(npdt),
        "rhs": rng.standard_normal(shape).astype(npdt),
        "a": rng.uniform(0.5, 2.0, shape).astype(npdt),
        "b": rng.uniform(0.5, 2.0, shape).astype(npdt),
    }


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cuda_level_kernels_match_plain(dt):
    _need_cuda()
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda()
         for k, v in fields((8, 12, 10), npdt).items()}
    kw = dict(kinds=KINDS, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25)
    kernel_counts.reset()
    ref = tfs.gsrb_relax_plain(f["u"], f["rhs"], f["a"], f["b"], nsweeps=4,
                               lo=(2, 0, 1), **kw)
    out = tfs.gsrb_relax(f["u"], f["rhs"], f["a"], f["b"], nsweeps=4,
                         lo=(2, 0, 1), **kw)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())
    ref = tfs.residual_plain(f["u"], f["rhs"], f["a"], f["b"], **kw)
    out = tfs.residual(f["u"], f["rhs"], f["a"], f["b"], **kw)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())
    assert kernel_counts.LAUNCHES["gsrb_relax"] == 1
    assert kernel_counts.LAUNCHES["residual"] == 1
    # one call = one launch each
    assert kernel_counts.DEVICE_LAUNCHES["gsrb_relax"] == 1
    assert kernel_counts.DEVICE_LAUNCHES["residual"] == 1
    # a CUDA tensor the kernel does not take raises; it never falls back
    with pytest.raises((TypeError, ValueError)):
        tfs.gsrb_relax(f["u"].half(), f["rhs"], f["a"], nsweeps=1,
                       lo=(0, 0, 0), **kw)


# gsrb_relax's launch forms (fused_sweeps.gsrb_geometry): (shape, kinds,
# lo, with_b, misaligned): tiles that do not divide the level with an odd
# lo, nx below the block count with periodic x (each tile's two x
# neighbours the same block), the periodic-x ring, the same with arrays off
# a 16-byte boundary (one element a copy), one block, variable b (grid form
# only)
GSRB_CASES = [
    ((270, 78, 80), ((C, C),) * 3, (1521, 960, 960), False, False),
    ((2, 64, 48), (("periodic", "periodic"), (D, C), (C, N)), (1, 0, 0),
     False, False),
    ((48, 40, 40), (("periodic", "periodic"), (D, C), (C, N)), (0, 1, 0),
     False, False),
    ((48, 40, 40), (("periodic", "periodic"), (D, C), (C, N)), (0, 1, 0),
     False, True),
    ((16, 16, 16), ((D, N), (C, D), (N, C)), (1, 0, 0), False, False),
    ((40, 30, 33), ((D, C), ("periodic", "periodic"), (C, N)), (0, 0, 1),
     True, False),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", GSRB_CASES,
                         ids=["uneven_tiles_odd_lo", "nx_below_blocks_ring",
                              "periodic_x_ring", "misaligned", "one_block",
                              "var_b"])
def test_cuda_gsrb_relax_forms_match_plain(case, dt):
    """gsrb_relax in every form that takes the level against its plain
    version: one launch per call, the input untouched."""
    _need_cuda()
    shape, kinds, lo, with_b, misaligned = case
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda() for k, v in fields(shape, npdt).items()}
    if misaligned:
        f = {k: _misaligned(v) for k, v in f.items()}
    b = f["b"] if with_b else None
    kw = dict(nsweeps=4, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25,
              lo=lo)
    ref = tfs.gsrb_relax_plain(f["u"], f["rhs"], f["a"], b, **kw)
    u_in = f["u"].clone()
    slab = npdt == np.float32 and not with_b
    for form in ("grid", "slab") if slab else ("grid",):
        kernel_counts.reset()
        out = tfs.gsrb_launch(f["u"], f["rhs"], f["a"], b, form=form, **kw)
        assert kernel_counts.DEVICE_LAUNCHES["gsrb_relax"] == 1
        assert float((out - ref).abs().max()) <= rtol * float(
            ref.abs().max())
        assert torch.equal(u_in, f["u"])


WAVE_CASES = [
    # (shape, kinds, lo)
    ((37, 18, 10), ((D, C), (C, D), (N, C)), (0, 3, 0)),
    ((100, 72, 56), ((C, C), (C, C), (C, C)), (49, 40, 40)),
    ((48, 40, 72), ((C, D), ("periodic", "periodic"), (C, N)), (0, 7, 0)),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("case", WAVE_CASES,
                         ids=["narrow", "odd_lo", "periodic_y"])
def test_cuda_wavefront_matches_plain_and_gsrb(case, nsweeps, dt):
    """wavefront_relax on the card against its plain version and against
    the gsrb_relax kernel (the same function in another kernel):
    one launch per call, and no giving way to another path."""
    _need_cuda()
    from mg_ic_code_tpu_torch.ops import wavefront as twf

    shape, kinds, lo = case
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda() for k, v in fields(shape, npdt).items()}
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.25, lo=lo)
    kernel_counts.reset()
    out = twf.wavefront_relax(f["u"], f["rhs"], f["a"], **kw)
    assert kernel_counts.LAUNCHES["wavefront_relax"] == 1
    assert kernel_counts.DEVICE_LAUNCHES["wavefront_relax"] == 1
    assert kernel_counts.PLAIN_CALLS["wavefront_relax"] == 0
    ref = twf.wavefront_relax_plain(f["u"], f["rhs"], f["a"], **kw)
    ker = tfs.gsrb_relax(f["u"], f["rhs"], f["a"], None, **kw)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= rtol * scale
    assert float((out - ker).abs().max()) <= rtol * scale
    with pytest.raises(ValueError, match="periodic"):
        twf.wavefront_relax(
            f["u"], f["rhs"], f["a"],
            **dict(kw, kinds=(("periodic", "periodic"),) + kinds[1:]))
    with pytest.raises((TypeError, ValueError)):
        twf.wavefront_relax(f["u"].half(), f["rhs"], f["a"], **kw)


@pytest.mark.requires_cuda
def test_cuda_relax_takes_the_wave_rung_on_a_big_level():
    """relax() on the card sends a level whose arrays exceed the L2 cache
    through wavefront_relax (4 sweeps = two launches of 2), a small one
    through gsrb_relax, and the two rungs agree."""
    _need_cuda()
    from mg_ic_code_tpu_torch.grid.boxes import Box

    def spec_of(shape):
        return tmg.LevelMGSpec(
            kinds=((C, C),) * 3, boxes=(Box.from_shape(shape),), dx=(0.25,),
            rho=(2.0,), alpha=1.0, beta=-1.0, nsmooth=4, smoother="auto")

    big = (512, 96, 96)
    f = {k: torch.from_numpy(v).cuda()
         for k, v in fields(big, np.float32).items()}
    spec = spec_of(big)
    coefs = {"a": (f["a"],), "b": (None,)}
    assert tmg.relax_kernel_plan(spec, f["u"], 4) == [("wave", 2)] * 2
    kernel_counts.reset()
    out = tmg.relax(spec, coefs, 0, f["u"], f["rhs"], 4)
    assert kernel_counts.LAUNCHES["wavefront_relax"] == 2
    assert kernel_counts.LAUNCHES["gsrb_relax"] == 0
    ref = tfs.gsrb_relax(f["u"], f["rhs"], f["a"], None, nsweeps=4,
                         kinds=spec.kinds, rho=2.0, alpha=1.0, beta=-1.0,
                         dx=0.25, lo=(0, 0, 0))
    assert float((out - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    small = spec_of((16, 16, 16))
    u = torch.zeros((16, 16, 16), dtype=torch.float32, device="cuda")
    assert tmg.relax_kernel_plan(small, u, 4) == [("resident", 4)]


@pytest.mark.requires_cuda
def test_cuda_tower_vcycle_matches_cpu_plain():
    """mg_vcycle on the card (tower kernels) against the same V-cycle on
    the CPU (plain versions): f32, 5e-5 absolute on O(1) data."""
    _need_cuda()
    n = 32
    spec = tmg.make_level_spec(
        single_level_geom(n, 1.0, BCSpec(bc_lo=(1, 0, 1), bc_hi=(0, 1, 0))),
        0, alpha=1.0, beta=-1.0, nsmooth=4, smoother="auto")
    f = fields((n, n, n), np.float32, seed=7)
    outs = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.from_numpy(v).to(dev) for k, v in f.items()}
        sp = spec if dev == "cuda" else tmg.make_level_spec(
            single_level_geom(n, 1.0, BCSpec(bc_lo=(1, 0, 1),
                                             bc_hi=(0, 1, 0))),
            0, alpha=1.0, beta=-1.0, nsmooth=4, smoother="pallas")
        coefs = tmg.build_level_coefs(sp, t["a"])
        kernel_counts.reset()
        outs[dev] = tmg.mg_vcycle(sp, coefs, t["u"], t["rhs"]).cpu()
        counts = kernel_counts.snapshot()
        which = "launches" if dev == "cuda" else "plain_calls"
        assert counts[which]["tower_down"] == 1
        assert counts[which]["tower_up"] == 1
        if dev == "cuda":  # 32^3 -> 4^3 in one launch each way
            assert counts["device_launches"]["tower_down"] == 1
            assert counts["device_launches"]["tower_up"] == 1
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=0, atol=5e-5)


P = "periodic"

# chip_smoke.TOWER_CASES: (shape, kinds, lo): the canonical 64^3 chain, the
# periodic box's from 128^3, the sharded paths' 16^3 chains (one block),
# a non-cube CF chain, mixed faces with an odd parity offset in z, one
# periodic axis, an odd bottom too big for the one-block tail, a bottom that
# is the whole tail
TOWER_CASES = [
    ((64, 64, 64), ((D, D),) * 3, (0, 0, 0)),
    ((128, 128, 128), ((P, P),) * 3, (0, 0, 0)),
    ((16, 16, 16), ((P, P),) * 3, (0, 0, 0)),
    ((16, 16, 16), ((D, D),) * 3, (0, 0, 0)),
    ((176, 64, 64), ((C, C),) * 3, (416, 288, 288)),
    ((32, 48, 40), ((D, C), (N, D), (C, N)), (16, 0, 8)),
    ((32, 32, 32), ((P, P), (D, C), (C, N)), (0, 0, 0)),
    ((68, 68, 68), ((D, N), (C, D), (N, C)), (4, 0, 8)),
    ((64, 64, 60), ((P, P), (P, P), (D, N)), (0, 4, 0)),
]


def tower_chain(shape, lo, kinds):
    """A LevelMGSpec whose depth chain coarsens `shape` while it stays
    2-coarsenable with every side >= 4 (as make_level_spec builds it)."""
    from mg_ic_code_tpu_torch.grid.boxes import Box

    boxes = [Box.from_shape(tuple(shape), tuple(lo))]
    while boxes[-1].coarsenable(2) and min(boxes[-1].coarsen(2).shape) >= 4:
        boxes.append(boxes[-1].coarsen(2))
    n = len(boxes)
    return tmg.LevelMGSpec(
        kinds=kinds, boxes=tuple(boxes), dx=tuple(0.11 * 2**d for d in
                                                  range(n)),
        rho=tuple(2.0 ** (1 - d) for d in range(n)), alpha=1.0, beta=-1.0,
        nsmooth=4, smoother="pallas")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", TOWER_CASES,
                         ids=["path_64", "periodic_128", "sharded_16_P",
                              "sharded_16", "l3_176x64x64", "mixed_faces",
                              "periodic_axis", "no_tail_68",
                              "bottom_tail_64x64x60"])
def test_cuda_towers_match_plain(case, dt):
    """tower_down and tower_up on the card against their plain versions:
    one launch per call, the inputs only read."""
    _need_cuda()
    from mg_ic_code_tpu_torch.ops import coarse_tower as tct
    from mg_ic_code_tpu_torch.ops import stencils as tst

    shape, kinds, lo = case
    npdt, rtol = DTYPES[dt]
    spec = tower_chain(shape, lo, kinds)
    f = {k: torch.from_numpy(v).cuda() for k, v in fields(shape, npdt).items()}
    a_list = [f["a"]]
    for _ in range(1, spec.ndepths):
        a_list.append(tst.coarsen_coef(a_list[-1], "harmonic").contiguous())
    kept = [t.clone() for t in [f["u"], f["rhs"]] + a_list]
    kernel_counts.reset()
    ku, kr, kb = tct.tower_down(spec, 0, f["u"], f["rhs"], a_list)
    pu, pr, pb = tct.tower_down_plain(spec, 0, f["u"], f["rhs"], a_list)
    for k, p in zip(list(ku) + list(kr) + [kb], list(pu) + list(pr) + [pb]):
        assert k.shape == p.shape
        assert float((k - p).abs().max()) <= rtol * float(p.abs().max())
    e_bot = 0.5 * pb
    rhs_list = [f["rhs"]] + list(pr)
    args = (spec, 0, e_bot, list(pu), rhs_list[:-1], a_list[:-1])
    out, ref = tct.tower_up(*args), tct.tower_up_plain(*args)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())
    for name in ("tower_down", "tower_up"):
        assert kernel_counts.LAUNCHES[name] == 1
        assert kernel_counts.DEVICE_LAUNCHES[name] == 1
    assert all(torch.equal(x, y) for x, y in
               zip(kept, [f["u"], f["rhs"]] + a_list))


MULTI_CASES = [
    # (shape, kinds, lo)
    ((38, 18, 10), ((P, P), (C, D), (N, C)), (0, 3, 0)),
    ((100, 72, 56), ((P, P), (C, C), (C, C)), (49, 40, 40)),
    ((66, 40, 24), ((P, P),) * 3, (1, 0, 0)),   # two x segments
    ((6, 44, 36), ((P, P),) * 3, (0, 0, 0)),    # one segment, wrapped twice
    ((40, 56, 48), ((D, C), (N, D), (C, N)), (3, 0, 8)),  # x open
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("case", MULTI_CASES,
                         ids=["narrow", "odd_lo", "two_segments", "tiny_nx",
                              "open_x"])
def test_cuda_multisweep_matches_plain_and_gsrb(case, nsweeps, dt):
    """multisweep_relax on the card against its plain version and against
    the gsrb_relax kernel: one launch per call, the input untouched, and no
    giving way to another path."""
    _need_cuda()
    shape, kinds, lo = case
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda() for k, v in fields(shape, npdt).items()}
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.25, lo=lo)
    kernel_counts.reset()
    u_in = f["u"].clone()
    out = tfs.multisweep_relax(f["u"], f["rhs"], f["a"], **kw)
    assert kernel_counts.LAUNCHES["multisweep_relax"] == 1
    assert kernel_counts.DEVICE_LAUNCHES["multisweep_relax"] == 1
    assert kernel_counts.PLAIN_CALLS["multisweep_relax"] == 0
    assert torch.equal(u_in, f["u"])
    ref = tfs.multisweep_relax_plain(f["u"], f["rhs"], f["a"], **kw)
    ker = tfs.gsrb_relax(f["u"], f["rhs"], f["a"], None, **kw)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= rtol * scale
    assert float((out - ker).abs().max()) <= rtol * scale
    with pytest.raises(ValueError, match="nsweeps"):
        tfs.multisweep_relax(f["u"], f["rhs"], f["a"], **dict(kw, nsweeps=3))
    with pytest.raises((TypeError, ValueError)):
        tfs.multisweep_relax(f["u"].half(), f["rhs"], f["a"], **kw)
    odd = f["u"][:-1].contiguous()
    if kinds[0][0] == P:
        with pytest.raises(ValueError, match="even"):
            tfs.multisweep_relax(odd, odd, odd, **kw)


# The whole-level march's tiles (fused_sweeps.march_tile): (shape, kinds,
# lo, misaligned). 144 is the finest level's width: the 44 tile at 2 sweeps
# in f32 (4 x 36 written), ragged for the others; 72 x 36 and 72 x 108 pick
# 44, 96 picks 40; narrow and wrapped levels, periodic y/z; `misaligned`
# hands the kernel arrays that start 4 bytes past a 16-byte boundary, and
# nz = 10 is no multiple of a 16-byte chunk: both take the element copies.
TILE_CASES = [
    ((20, 144, 144), ((C, C),) * 3, (1, 0, 0), False),
    ((40, 72, 36), ((D, C), (N, D), (C, N)), (3, 1, 8), False),
    ((32, 72, 108), ((P, P),) * 3, (0, 1, 0), False),
    ((6, 36, 72), ((P, P),) * 3, (1, 0, 0), False),
    ((66, 36, 36), ((P, P), (D, N), (C, D)), (0, 0, 1), False),
    ((24, 96, 96), ((C, D), (P, P), (N, C)), (0, 7, 0), False),
    ((37, 18, 10), ((D, C), (C, D), (N, C)), (0, 3, 0), False),
    ((2, 12, 8), ((P, P), (N, D), (P, P)), (1, 0, 0), False),
    ((40, 72, 36), ((C, C),) * 3, (0, 0, 0), True),
]


def _misaligned(t):
    """t's values in a tensor whose data starts one element past the start
    of its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("case", TILE_CASES,
                         ids=["ragged_144", "tile44_odd_lo",
                              "tile44_periodic", "tile44_wrap_nx6",
                              "tile44_two_segments", "tile40_96",
                              "narrow_nz10", "wrap_nx2", "misaligned"])
def test_cuda_march_tiles_match_plain(case, nsweeps, dt):
    """The whole-level march with each tile it can pick (x periodic through
    multisweep_relax, x open through wavefront_relax) against its plain
    version: one launch per call, the tile march_geometry names."""
    _need_cuda()
    from mg_ic_code_tpu_torch.ops import wavefront as twf

    shape, kinds, lo, misaligned = case
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda() for k, v in fields(shape, npdt).items()}
    if misaligned:
        f = {k: _misaligned(v) for k, v in f.items()}
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.25, lo=lo)
    x_open = kinds[0][0] != P
    name = "wavefront_relax" if x_open else "multisweep_relax"
    fn, plain = ((twf.wavefront_relax, twf.wavefront_relax_plain) if x_open
                 else (tfs.multisweep_relax, tfs.multisweep_relax_plain))
    tile, nseg, xseg = tfs.march_geometry_on(f["u"], nsweeps)
    assert tile == tfs.march_tile(shape[1], shape[2], nsweeps,
                                  f["u"].element_size())
    assert nseg == -(-shape[0] // xseg)
    kernel_counts.reset()
    out = fn(f["u"], f["rhs"], f["a"], **kw)
    assert kernel_counts.DEVICE_LAUNCHES[name] == 1
    assert kernel_counts.PLAIN_CALLS[name] == 0
    ref = plain(f["u"], f["rhs"], f["a"], **kw)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cuda_sweep_entry_points_match_plain(dt):
    """gsrb_full_sweep and gsrb_half_sweep (one launch each, counted under
    their own names) against their plain versions on a box with an odd
    sum(lo)."""
    _need_cuda()
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda()
         for k, v in fields((12, 10, 14), npdt, seed=2).items()}
    args = (f["u"], f["rhs"], f["a"], f["b"])
    kw = dict(kinds=KINDS, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25,
              lo=(2, 0, 1))
    kernel_counts.reset()
    u_in = f["u"].clone()
    full = tfs.gsrb_full_sweep(*args, **kw)
    assert kernel_counts.DEVICE_LAUNCHES["gsrb_full_sweep"] == 1
    ref = tfs.gsrb_full_sweep_plain(*args, **kw)
    assert float((full - ref).abs().max()) <= rtol * float(ref.abs().max())
    halves = []
    for color in (0, 1):
        out = tfs.gsrb_half_sweep(*args, color=color, **kw)
        ref = tfs.gsrb_half_sweep_plain(*args, color=color, **kw)
        assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())
        halves.append(out)
    assert kernel_counts.DEVICE_LAUNCHES["gsrb_half_sweep"] == 2
    assert kernel_counts.LAUNCHES["gsrb_half_sweep"] == 2
    assert kernel_counts.LAUNCHES["gsrb_relax"] == 0
    assert torch.equal(f["u"], u_in)
    two = tfs.gsrb_half_sweep(halves[0], *args[1:], color=1, **kw)
    assert torch.equal(full, two)
    assert torch.equal(full, tfs.gsrb_relax(*args, nsweeps=1, **kw))


@pytest.mark.requires_cuda
def test_cuda_vcycle_stages_a_big_periodic_level_above_the_tower():
    """mg_vcycle on a 256^3 periodic level on the card: the top depth is too
    big for the tower, goes through relax's multisweep rung (two launches
    before, two after), and the tower starts at 128^3."""
    _need_cuda()
    n = 256
    spec = tmg.make_level_spec(
        single_level_geom(n, 16.0, BCSpec(periodic=True)), 0, alpha=1.0,
        beta=-1.0, nsmooth=4, smoother="auto")
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    mk = lambda: torch.randn((n, n, n), dtype=torch.float32, device="cuda",
                             generator=g)
    u, rhs = mk(), mk()
    # alpha*a*u - beta*lap(u) = a*u + lap(u): definite for a < 0
    a = -(0.5 + mk().abs())
    coefs = tmg.build_level_coefs(spec, a)
    assert tmg.relax_kernel_plan(spec, u, 4) == [("multisweep", 2)] * 2
    kernel_counts.reset()
    out = tmg.mg_vcycle(spec, coefs, u, rhs)
    counts = kernel_counts.snapshot()
    assert counts["launches"]["multisweep_relax"] == 4
    assert counts["launches"]["tower_down"] == 1
    assert counts["launches"]["tower_up"] == 1
    assert counts["launches"]["gsrb_relax"] == 0
    assert all(v == 0 for v in counts["plain_calls"].values())
    # one V-cycle contracts the residual of this definite operator
    res0 = tmg.residual_homog(spec, coefs, 0, u, rhs)
    res1 = tmg.residual_homog(spec, coefs, 0, out, rhs)
    assert float(res1.abs().max()) < 0.5 * float(res0.abs().max())


def _halo_pads(u, H, meta, kinds, npdt, seed, h_max=None):
    """(2H, ny, nz) pads: random neighbour rows, the contract's fill at a
    domain x face (the ghost plane in u's pad, zeros in rhs's and a's).
    h_max: rhs's and a's pads drawn h_max rows a side and sliced
    [h_max - H, h_max + H), as halo.sharded_relax slices them."""
    from mg_ic_code_tpu_torch.ops.ghosts import ghost_plane

    rng = np.random.default_rng(seed)
    shape = (2 * H,) + tuple(u.shape[1:])
    deep = (2 * (h_max or H),) + tuple(u.shape[1:])
    sl = slice((h_max or H) - H, (h_max or H) + H)
    pads = [torch.from_numpy(rng.standard_normal(shape).astype(npdt)),
            torch.from_numpy(rng.standard_normal(deep).astype(npdt)),
            torch.from_numpy(rng.uniform(0.5, 2.0, deep).astype(npdt))]
    pads = [pads[0].to(u.device)] + [p.to(u.device)[sl] for p in pads[1:]]
    if kinds[0][0] != P:
        if meta[0]:
            pads[0][:H] = ghost_plane(kinds[0][0], u[:1], u[1:2], 2.0)
            pads[1][:H] = 0.0
            pads[2][:H] = 0.0
        if meta[1]:
            pads[0][H:] = ghost_plane(kinds[0][1], u[-1:], u[-2:-1], 2.0)
            pads[1][H:] = 0.0
            pads[2][H:] = 0.0
    return pads


def _wrapped_pads(f, H):
    """The pads of a one-shard periodic x mesh: the slab's own rows, its
    top H below it and its bottom H above it."""
    return [torch.cat([f[k][-H:], f[k][:H]]) for k in ("u", "rhs", "a")]


HALO_CASES = [
    # (shape, kinds, meta, lo, pads): seams, faces, periodic x through the
    # pads, odd x offsets, a slab longer than one x segment; then rows that
    # do not start on 16 bytes (nz odd), rhs and a pads sliced from pads
    # built 8 rows a side ("hmax8"), a slab cut into several x segments, and
    # a one-shard periodic x mesh whose pads are its own rows ("wrap")
    ((24, 40, 36), ((D, C), (N, D), (C, N)), (0, 0, 7, 0), (1, 0, 0), None),
    ((24, 40, 36), ((N, D), (C, C), (D, D)), (1, 0, 0, 0), (0, 3, 0), None),
    ((24, 40, 36), ((N, D), (C, C), (D, D)), (0, 1, 23, 0), (0, 3, 0), None),
    ((24, 18, 10), ((D, D), (D, D), (D, D)), (1, 1, 0, 0), (0, 0, 0), None),
    ((40, 44, 36), ((P, P), (P, P), (P, P)), (0, 0, 5, 0), (0, 0, 0), None),
    ((80, 24, 40), ((P, P), (D, D), (P, P)), (0, 0, 80, 0), (0, 1, 0), None),
    ((24, 40, 37), ((D, C), (N, D), (C, N)), (0, 0, 7, 0), (1, 0, 0), None),
    ((24, 40, 36), ((D, C), (N, D), (C, N)), (0, 0, 24, 0), (0, 1, 0),
     "hmax8"),
    ((132, 40, 36), ((N, D), (D, C), (C, C)), (0, 0, 132, 0), (0, 1, 1),
     None),
    ((48, 40, 36), ((P, P), (P, P), (P, P)), (0, 0, 0, 0), (0, 1, 0), "wrap"),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("case", HALO_CASES,
                         ids=["seams_odd", "face_lo", "face_hi", "both_faces",
                              "periodic_x", "two_segments", "misaligned_nz",
                              "pad_slice_hmax8", "segments",
                              "one_shard_periodic"])
def test_cuda_multisweep_halo_matches_plain(case, nsweeps, dt):
    """multisweep_relax(halo=...) on the card against its plain version:
    one launch, its own counter, no plain call."""
    _need_cuda()
    shape, kinds, meta, lo, how = case
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda() for k, v in fields(shape, npdt).items()}
    H = 2 * nsweeps
    pads = (_wrapped_pads(f, H) if how == "wrap" else
            _halo_pads(f["u"], H, meta, kinds, npdt, seed=5,
                       h_max=8 if how == "hmax8" else None))
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.25, lo=lo)
    kernel_counts.reset()
    out = tfs.multisweep_relax(f["u"], f["rhs"], f["a"],
                               halo=tuple(pads) + (meta,), **kw)
    assert kernel_counts.LAUNCHES["multisweep_relax_halo"] == 1
    assert kernel_counts.DEVICE_LAUNCHES["multisweep_relax_halo"] == 1
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_halo"] == 0
    ref = tfs.multisweep_relax_halo_plain(f["u"], f["rhs"], f["a"], *pads,
                                          meta, **kw)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())


PRE_CASES = [
    # (pencil shape, kinds, meta, ny_global, lo, x pads): then rows that do
    # not start on 16 bytes (nz odd), a pencil cut into several x segments,
    # and a one-shard periodic x mesh whose x pads are its own planes
    # ("wrap")
    ((24, 40, 36), ((D, C), (N, D), (C, N)), (0, 0, 9, 40), 120, (1, 0, 0),
     None),
    ((24, 40, 36), ((N, D), (D, N), (D, D)), (1, 0, 0, 0), 80, (0, 3, 0),
     None),
    ((24, 40, 36), ((N, D), (D, N), (D, D)), (0, 1, 24, 40), 80, (0, 3, 0),
     None),
    ((16, 8, 12), ((D, D), (D, D), (D, D)), (1, 1, 0, 0), 8, (0, 0, 0), None),
    ((40, 44, 36), ((P, P), (P, P), (P, P)), (0, 0, 5, 3), 88, (0, 0, 0),
     None),
    ((24, 40, 37), ((D, C), (N, D), (C, N)), (0, 0, 9, 40), 120, (1, 0, 0),
     None),
    ((132, 24, 36), ((N, D), (D, N), (C, C)), (0, 0, 132, 24), 72, (0, 1, 0),
     None),
    ((48, 40, 36), ((P, P), (P, P), (P, P)), (0, 0, 0, 40), 80, (0, 1, 0),
     "wrap"),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("case", PRE_CASES,
                         ids=["interior_odd", "faces_lo", "faces_hi",
                              "whole", "periodic_odd", "misaligned_nz",
                              "segments", "one_shard_periodic"])
def test_cuda_multisweep_tiled_pre_matches_plain(case, nsweeps, dt):
    """multisweep_relax_tiled_pre on the card against its plain version."""
    _need_cuda()
    shape, kinds, meta, ny_global, lo, how = case
    npdt, rtol = DTYPES[dt]
    H = 2 * nsweeps
    pre = (shape[0] + 2 * H, shape[1] + 2 * H, shape[2])
    f = {k: torch.from_numpy(v).cuda() for k, v in fields(pre, npdt).items()}
    if how == "wrap":
        for v in f.values():
            v[:H] = v[shape[0]:shape[0] + H].clone()
            v[shape[0] + H:] = v[H:2 * H].clone()
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.25, lo=lo, ny_global=ny_global)
    kernel_counts.reset()
    out = tfs.multisweep_relax_tiled_pre(f["u"], f["rhs"], f["a"], meta, **kw)
    assert kernel_counts.LAUNCHES["multisweep_relax_tiled_pre"] == 1
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_tiled_pre"] == 0
    assert out.shape == shape
    ref = tfs.multisweep_relax_tiled_pre_plain(f["u"], f["rhs"], f["a"], meta,
                                               **kw)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mshape", [(4,), (2, 2)])
@pytest.mark.parametrize("kinds", [((P, P),) * 3, ((D, C), (N, D), (C, N))],
                         ids=["periodic", "open"])
def test_cuda_sharded_relax_on_one_card(kinds, mshape):
    """relax() with a mesh that names cuda:0 four times: every shard runs
    the halo kernel (slabs) or the prepadded one (pencils), and the joined
    level agrees with the unsharded kernel on the whole level."""
    _need_cuda()
    from mg_ic_code_tpu_torch.grid.boxes import Box
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh

    shape, lo = (64, 48, 40), (0, 1, 0)
    mesh = pmesh.make_mesh(["cuda:0"] * 4, mshape)
    spec = tmg.LevelMGSpec(
        kinds=kinds, boxes=(Box.from_shape(shape, lo),), dx=(0.25,),
        rho=(2.0,), alpha=1.0, beta=-1.0, nsmooth=4, smoother="auto",
        mesh=mesh)
    f = {k: torch.from_numpy(v).cuda()
         for k, v in fields(shape, np.float32).items()}
    coefs = {"a": (f["a"],), "b": (None,), "lam": (None,)}
    kernel_counts.reset()
    out = tmg.relax(spec, coefs, 0, f["u"], f["rhs"], 4)
    name = ("multisweep_relax_halo" if len(mshape) == 1
            else "multisweep_relax_tiled_pre")
    assert kernel_counts.LAUNCHES[name] == 8  # 2 chunks x 4 shards
    assert all(v == 0 for v in kernel_counts.PLAIN_CALLS.values())
    kw = dict(kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25, lo=lo)
    ref = tfs.multisweep_relax(f["u"], f["rhs"], f["a"], nsweeps=2, **kw)
    ref = tfs.multisweep_relax(ref, f["rhs"], f["a"], nsweeps=2, **kw)
    assert float((out - ref).abs().max()) <= 2e-6 * float(ref.abs().max())


# residual_restrict's forms (fused_sweeps.residual_form): (shape, kinds,
# with_b, misaligned): 16 bytes a thread with every face kind, nz = 2 mod 4
# (two cells a thread in f32), operands off a 16-byte boundary (two cells a
# thread, one copy a cell), all periodic with variable b
RESTRICT_CASES = [
    ((16, 24, 20), KINDS, False, False),
    ((12, 10, 18), ((C, C), ("periodic", "periodic"), (D, N)), True, False),
    ((12, 10, 16), KINDS, False, True),
    ((8, 8, 8), (("periodic", "periodic"),) * 3, True, False),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", RESTRICT_CASES,
                         ids=["vec", "nz_2_mod_4", "misaligned",
                              "periodic_var_b"])
def test_cuda_residual_restrict_matches_plain(case, dt):
    """residual_restrict against its plain version, one launch a call, bit
    for bit restrict_full of the residual kernel's output, and into a
    strided slice of a parent that it leaves untouched elsewhere."""
    _need_cuda()
    shape, kinds, with_b, misaligned = case
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda() for k, v in fields(shape, npdt).items()}
    if misaligned:
        f = {k: _misaligned(v) for k, v in f.items()}
    args = (f["u"], f["rhs"], f["a"], f["b"] if with_b else None)
    kw = dict(kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25)
    ref = tfs.residual_restrict_plain(*args, **kw)
    kernel_counts.reset()
    out = tfs.residual_restrict(*args, **kw)
    assert kernel_counts.DEVICE_LAUNCHES["residual_restrict"] == 1
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())
    assert torch.equal(out, tfs.restrict_full(tfs.residual(*args, **kw)))
    half = tuple(n // 2 for n in shape)
    parent = torch.full(tuple(n + 2 for n in half), -7.0, dtype=out.dtype,
                        device="cuda")
    view = parent[1:1 + half[0], 2:2 + half[1], :half[2]]
    tfs.residual_restrict(*args, out=view, **kw)
    assert torch.equal(view, out)
    parent[1:1 + half[0], 2:2 + half[1], :half[2]] = -7.0
    assert bool((parent == -7.0).all())


# the batched forms (a batch group's same-shape patches in one launch):
# (shape, kinds, the patches' lo): a slab-form pair, three patches in the
# grid form at odd parity, the 144^3 pair in the march form (two patches'
# arrays over the L2; the serial form too), three 144^3 patches at odd
# parity in the march form
BATCH_CASES = [
    ((72, 80, 80), ((C, C),) * 3, ((376, 472, 472), (376, 552, 472))),
    ((48, 48, 48), KINDS, ((1, 0, 0), (49, 0, 0), (1, 48, 2))),
    ((144, 144, 144), ((C, C),) * 3, ((1568, 1976, 1976), (1568, 2120, 1976))),
    ((144, 144, 144), ((C, C),) * 3,
     ((1569, 1976, 1976), (1569, 2120, 1976), (1569, 2264, 1976))),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", BATCH_CASES,
                         ids=["pair_slab", "three_odd", "pair_144",
                              "three_144_odd"])
def test_cuda_batched_kernels_match_plain_and_single(case, dt):
    """gsrb_relax_batch and residual_restrict_batch in every form
    gsrb_geometry takes for the batch: each patch within the plain
    version's tolerance and bit for bit the single wrapper's; one launch a
    call."""
    _need_cuda()
    shape, kinds, los = case
    npdt, rtol = DTYPES[dt]
    fs_ = [{k: torch.from_numpy(v).cuda()
            for k, v in fields(shape, npdt, seed=k).items()}
           for k in range(len(los))]
    us, rhss, as_ = ([f[k] for f in fs_] for k in ("u", "rhs", "a"))
    kw = dict(kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25)
    ref = tfs.gsrb_relax_batch_plain(us, rhss, as_, nsweeps=4, los=los, **kw)
    single = [tfs.gsrb_relax(u, r, a, nsweeps=4, lo=lo, **kw)
              for u, r, a, lo in zip(us, rhss, as_, los)]
    cap = tfs.gsrb_capacity(us[0].device, us[0].element_size())
    for form in tfs.GSRB_FORMS:
        try:
            tfs.gsrb_geometry(shape, us[0].element_size(), False, kinds, cap,
                              form, patches=len(los), nsweeps=4)
        except ValueError:
            continue
        kernel_counts.reset()
        out = tfs.gsrb_batch_launch(us, rhss, as_, nsweeps=4, los=los,
                                    form=form, **kw)
        name = ("gsrb_relax_batch_march" if form == "march"
                else "gsrb_relax_batch")
        assert kernel_counts.DEVICE_LAUNCHES[name] == 1
        for o, r, s in zip(out, ref, single):
            assert float((o - r).abs().max()) <= rtol * float(
                r.abs().max())
            assert torch.equal(o, s), form
    kernel_counts.reset()
    rc = tfs.residual_restrict_batch(us, rhss, as_, **kw)
    assert kernel_counts.DEVICE_LAUNCHES["residual_restrict_batch"] == 1
    for o, u, r, a in zip(rc, us, rhss, as_):
        assert torch.equal(o, tfs.residual_restrict(u, r, a, **kw))
