"""The port's multisweep smoother against the JAX package's three
halo-recompute multisweep kernels.

JAX side: `fused_sweeps.multisweep_relax_pipelined` (x slabs, widths 1, 2,
4), `multisweep_relax_flat_pipelined` (the flattened layout) and
`multisweep_relax_tiled` ((x, y) tiles, with prepadded and padless halos),
each with interpret=True (how the JAX package's own tests run its Pallas
kernels on the CPU). They are three TPU tilings of ONE function; the port
has one kernel for it. Port side: `multisweep_relax` on CPU tensors, which
takes the plain PyTorch version (the CUDA kernel has no interpret mode; it
is held against this same plain version on the card).

Tolerances: 1e-12 absolute in f64 on O(1) data (the same folded update in
the same order, apart from FMA contraction), 2e-6 of max|result| in f32.

Then the rules of the rung: which level takes the kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.ops import fused_sweeps as jfs

from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts

torch.set_num_threads(1)

D, NM, CF, PER = "dirichlet", "neumann", "cf", "periodic"
# the three cases of tests/test_fused_sweeps.py, and periodic x with
# non-periodic y and z (wrapped x halos beside ghost-rule faces)
KINDS = {
    "mixed": ((D, D), (NM, D), (D, NM)),
    "periodic": ((PER, PER),) * 3,
    "cf": ((CF, CF), (CF, D), (D, CF)),
    "periodic_x": ((PER, PER), (D, D), (D, D)),
}
DTYPES = {"f64": (np.float64, 1e-12, None), "f32": (np.float32, None, 2e-6)}
KW = dict(rho=2.0, alpha=1.0, beta=-1.0, dx=0.1)
ODD_LO = (3, 1, 1)


def fields(shape, npdt, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(npdt),
            rng.standard_normal(shape).astype(npdt),
            rng.uniform(0.5, 2.0, shape).astype(npdt))


def close(t, j, atol, rtol):
    j = np.asarray(j)
    assert t.dtype == getattr(torch, str(j.dtype))
    if atol is None:
        atol = rtol * float(np.max(np.abs(j)))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol)


def port(u, rhs, a, **kw):
    """multisweep_relax on CPU tensors: the plain version, counted as such."""
    before = kernel_counts.PLAIN_CALLS["multisweep_relax"]
    out = tfs.multisweep_relax(torch.from_numpy(u), torch.from_numpy(rhs),
                               torch.from_numpy(a), **kw)
    assert kernel_counts.PLAIN_CALLS["multisweep_relax"] == before + 1
    assert kernel_counts.LAUNCHES["multisweep_relax"] == 0
    return out


def jax_args(u, rhs, a):
    return jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("kinds", list(KINDS))
def test_matches_jax_pipelined(kinds, nsweeps, width):
    u, rhs, a = fields((32, 8, 128), np.float64, seed=8)
    kw = dict(nsweeps=nsweeps, kinds=KINDS[kinds], lo=(0, 0, 0), **KW)
    ref = jfs.multisweep_relax_pipelined(*jax_args(u, rhs, a), width=width,
                                         interpret=True, **kw)
    close(port(u, rhs, a, **kw), ref, 1e-12, None)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kinds", list(KINDS))
def test_matches_jax_pipelined_odd_lo(kinds, dt):
    """Odd sum(lo): the other checkerboard parity, in both dtypes."""
    npdt, atol, rtol = DTYPES[dt]
    u, rhs, a = fields((16, 8, 128), npdt, seed=9)
    kw = dict(nsweeps=2, kinds=KINDS[kinds], lo=ODD_LO, **KW)
    ref = jfs.multisweep_relax_pipelined(*jax_args(u, rhs, a), width=2,
                                         interpret=True, **kw)
    close(port(u, rhs, a, **kw), ref, atol, rtol)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("kinds", list(KINDS))
def test_matches_jax_flat_pipelined(kinds, width):
    """The flattened-layout twin (nz not a multiple of 128 there) computes
    the same function: the one port kernel is its counterpart too."""
    shape = (32, 16, 16)
    assert jfs.flat_pipelined_supported(shape, 4, width=width)
    u, rhs, a = fields(shape, np.float64, seed=5)
    kw = dict(nsweeps=4, kinds=KINDS[kinds], lo=(0, 0, 0), **KW)
    ref = jfs.multisweep_relax_flat_pipelined(
        *jax_args(u, rhs, a), width=width, interpret=True, **kw)
    close(port(u, rhs, a, **kw), ref, 1e-12, None)


@pytest.mark.parametrize("kinds", list(KINDS))
def test_matches_jax_flat_pipelined_odd_lo_f32(kinds):
    u, rhs, a = fields((32, 16, 16), np.float32, seed=6)
    kw = dict(nsweeps=4, kinds=KINDS[kinds], lo=ODD_LO, **KW)
    ref = jfs.multisweep_relax_flat_pipelined(
        *jax_args(u, rhs, a), width=1, interpret=True, **kw)
    close(port(u, rhs, a, **kw), ref, None, 2e-6)


@pytest.mark.parametrize("bx,by,nsweeps", [(8, 8, 2), (4, 8, 2), (8, 16, 4)])
@pytest.mark.parametrize("kinds", list(KINDS))
def test_matches_jax_tiled(kinds, bx, by, nsweeps):
    """The (x, y)-tiled kernel with prepadded halos (16 x 16 x 128 has a
    single tile along an axis in each of these tilings)."""
    u, rhs, a = fields((16, 16, 128), np.float64, seed=3)
    kw = dict(nsweeps=nsweeps, kinds=KINDS[kinds], lo=(0, 0, 0), **KW)
    ref = jfs.multisweep_relax_tiled(*jax_args(u, rhs, a), bx=bx, by=by,
                                     interpret=True, **kw)
    close(port(u, rhs, a, **kw), ref, 1e-12, None)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kinds", ["mixed", "cf", "periodic_x"])
def test_matches_jax_tiled_padless_odd_lo(kinds, dt):
    """The padless form of the tiled kernel (clamped-window y halos fixed up
    in the kernel, x side pads), on an offset box."""
    npdt, atol, rtol = DTYPES[dt]
    shape = (32, 32, 128)
    assert jfs.tiled_padless_ok(shape, 8, 8, 4, KINDS[kinds])
    u, rhs, a = fields(shape, npdt, seed=7)
    kw = dict(nsweeps=4, kinds=KINDS[kinds], lo=(3, 5, 9), **KW)
    ref = jfs.multisweep_relax_tiled(*jax_args(u, rhs, a), bx=8, by=8,
                                     interpret=True, **kw)
    close(port(u, rhs, a, **kw), ref, atol, rtol)


def test_plain_is_the_gsrb_function():
    """multisweep_relax and gsrb_relax compute one function: their plain
    versions share a body, so on the CPU they agree bitwise."""
    u, rhs, a = (torch.from_numpy(x)
                 for x in fields((12, 10, 8), np.float32, seed=3))
    kw = dict(nsweeps=2, kinds=KINDS["periodic_x"], lo=(1, 0, 0), **KW)
    assert torch.equal(tfs.multisweep_relax_plain(u, rhs, a, **kw),
                       tfs.gsrb_relax_plain(u, rhs, a, None, **kw))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    u = torch.zeros((8, 8, 8), dtype=torch.float32)
    kw = dict(kinds=KINDS["periodic"], lo=(0, 0, 0), **KW)
    with pytest.raises(ValueError, match="nsweeps"):
        tfs.multisweep_relax(u, u, u, nsweeps=3, **kw)
    with pytest.raises(ValueError, match="nsweeps"):
        tfs.multisweep_relax(u, u, u, nsweeps=1, **kw)


def test_multisweep_supported_rules():
    per, big = KINDS["periodic"], (256, 256, 256)
    assert tfs.multisweep_supported(big, 2, per)
    assert tfs.multisweep_supported(big, 4, per)
    assert not tfs.multisweep_supported(big, 1, per)      # no such chunk
    assert not tfs.multisweep_supported(big, 2, None)     # faces unknown
    # an odd periodic extent: the checkerboard breaks across the wrap
    assert not tfs.multisweep_supported((255, 256, 256), 2, per)
    assert not tfs.multisweep_supported((256, 256, 255), 2, per)
    assert tfs.multisweep_supported((255, 256, 256), 2, KINDS["cf"])
    # the size term: four arrays of the level against the 50 MB L2
    assert tfs.L2_BYTES == 50 << 20
    assert not tfs.multisweep_supported((128, 128, 128), 2, per)   # 33 MB
    assert tfs.multisweep_supported((128, 128, 128), 2, per, itemsize=8)
    assert tfs.multisweep_supported((512, 96, 96), 2, KINDS["periodic_x"])
    assert not tfs.multisweep_supported((272, 80, 80), 2,
                                        KINDS["periodic_x"])
    assert tfs.multisweep_plan(big, 4, per) == 2
    assert tfs.multisweep_plan(big, 2, per) == 2
    assert tfs.multisweep_plan(big, 5, per) is None
    assert tfs.multisweep_plan(big, 0, per) is None
    assert tfs.multisweep_plan((64, 64, 64), 4, per) is None
