"""The port's one-sweep and one-pass entry points against the JAX package's
per-sweep kernels.

JAX side: `pallas_kernels.gsrb_full_sweep` (one red + black sweep per
launch) and `pallas_kernels.gsrb_half_sweep` (one colour pass,
base = sum(lo) + color), each with interpret=True as tests/test_pallas.py
runs them. Port side: `fused_sweeps.gsrb_full_sweep` / `gsrb_half_sweep` on
CPU tensors, which take their plain PyTorch versions (on the card each is
one launch of csrc/gsrb_sweep.cu, counted under its own name).

Tolerances: 1e-12 absolute in f64 on O(1) data, 2e-6 of max|result| in
f32. An offset box with an ODD sum(lo) settles the parity convention: a
colour pass updates the cells with (i + j + k + sum(lo) + color) even.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.ops import pallas_kernels as jpk

from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts

torch.set_num_threads(1)

D, NM, CF, PER = "dirichlet", "neumann", "cf", "periodic"
KINDS = {
    "mixed": ((D, D), (NM, D), (D, NM)),
    "periodic": ((PER, PER),) * 3,
    "cf": ((CF, CF), (CF, D), (D, CF)),
}
DTYPES = {"f64": (np.float64, 1e-12, None), "f32": (np.float32, None, 2e-6)}
LOS = {"lo0": (0, 0, 0), "odd_lo": (5, 2, 10), "even_lo": (3, 1, 2)}
KW = dict(rho=2.0, alpha=0.7, beta=-1.0, dx=0.2)
SHAPE = (16, 8, 128)


def fields(npdt, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(npdt),
            rng.standard_normal(SHAPE).astype(npdt),
            rng.uniform(0.5, 2.0, SHAPE).astype(npdt))


def close(t, j, atol, rtol):
    j = np.asarray(j)
    assert t.dtype == getattr(torch, str(j.dtype))
    if atol is None:
        atol = rtol * float(np.max(np.abs(j)))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("lo", list(LOS))
@pytest.mark.parametrize("kinds", list(KINDS))
def test_full_sweep_matches_jax(kinds, lo, dt):
    npdt, atol, rtol = DTYPES[dt]
    u, rhs, a = fields(npdt, seed=1)
    kw = dict(kinds=KINDS[kinds], lo=LOS[lo], **KW)
    ref = jpk.gsrb_full_sweep(jnp.asarray(u), jnp.asarray(rhs),
                              jnp.asarray(a), interpret=True, **kw)
    before = kernel_counts.PLAIN_CALLS["gsrb_full_sweep"]
    out = tfs.gsrb_full_sweep(torch.from_numpy(u), torch.from_numpy(rhs),
                              torch.from_numpy(a), **kw)
    assert kernel_counts.PLAIN_CALLS["gsrb_full_sweep"] == before + 1
    assert kernel_counts.LAUNCHES["gsrb_full_sweep"] == 0
    close(out, ref, atol, rtol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("lo", list(LOS))
@pytest.mark.parametrize("kinds", list(KINDS))
def test_half_sweep_matches_jax(kinds, lo, color, dt):
    npdt, atol, rtol = DTYPES[dt]
    u, rhs, a = fields(npdt, seed=2)
    kw = dict(kinds=KINDS[kinds], lo=LOS[lo], color=color, **KW)
    ref = jpk.gsrb_half_sweep(jnp.asarray(u), jnp.asarray(rhs),
                              jnp.asarray(a), interpret=True, **kw)
    out = tfs.gsrb_half_sweep(torch.from_numpy(u), torch.from_numpy(rhs),
                              torch.from_numpy(a), **kw)
    close(out, ref, atol, rtol)
    # the pass leaves the cells of the other colour as they were (the plain
    # version blends update and old value by the parity mask, which costs a
    # rounding or two; the kernel on the card does not visit them at all)
    i, j, k = np.ogrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    kept = np.broadcast_to(
        (i + j + k + sum(LOS[lo]) + color) % 2 == 1, SHAPE)
    eps = np.finfo(npdt).eps
    np.testing.assert_allclose(out.numpy()[kept], u[kept], rtol=0,
                               atol=64 * eps)
    assert np.max(np.abs(out.numpy()[~kept] - u[~kept])) > 1e-2


@pytest.mark.parametrize("lo", list(LOS))
def test_full_sweep_is_two_half_sweeps_is_one_relax_sweep(lo):
    u, rhs, a = (torch.from_numpy(x) for x in fields(np.float64, seed=3))
    b = torch.from_numpy(
        np.random.default_rng(4).uniform(0.5, 2.0, SHAPE))
    kw = dict(kinds=KINDS["mixed"], lo=LOS[lo], **KW)
    full = tfs.gsrb_full_sweep(u, rhs, a, b, **kw)
    half = tfs.gsrb_half_sweep(u, rhs, a, b, color=0, **kw)
    half = tfs.gsrb_half_sweep(half, rhs, a, b, color=1, **kw)
    assert torch.equal(full, half)
    assert torch.equal(full, tfs.gsrb_relax(u, rhs, a, b, nsweeps=1, **kw))
