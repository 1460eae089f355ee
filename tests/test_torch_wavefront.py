"""The port's wavefront rung against the JAX package's wavefront kernels,
and the port's residual against the JAX package's one-pass residual.

JAX side: `wavefront.wavefront_relax` (3-D layout), `wavefront_relax_flat`
(flattened layout) and `pallas_kernels.residual`, each with interpret=True
(how the JAX package's own tests run its Pallas kernels on the CPU). Port
side: `wavefront_relax` / `residual` on CPU tensors, which take the plain
PyTorch versions (the CUDA kernels have no interpret mode; they are held
against these same plain versions on the card).

Tolerances: 1e-13 absolute in f64 on O(1) data (the standard of
tests/test_wavefront.py: the same folded update in the same order, apart
from FMA contraction), 2e-6 relative to max|result| in f32.

Then the rung itself: which level shape takes which kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.ops import pallas_kernels as jpk
from mg_ic_code_tpu.ops import wavefront as jwf

from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.ops import wavefront as twf
from mg_ic_code_tpu_torch.solver import multigrid as tmg

torch.set_num_threads(1)

D, NM, CF, PER = "dirichlet", "neumann", "cf", "periodic"
KINDS = {
    "dirichlet": ((D, D), (D, D), (D, D)),
    "mixed": ((NM, D), (D, NM), (NM, NM)),
    "cf": ((CF, CF), (CF, CF), (CF, CF)),
    "periodic_yz": ((CF, D), (PER, PER), (PER, PER)),
}
DTYPES = {"f64": (np.float64, 1e-13, None), "f32": (np.float32, None, 2e-6)}
KW = dict(rho=2.0, alpha=1.0, beta=-1.0, dx=0.05)


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


# (shape, bx of the JAX kernel, nsweeps, lo)
WAVE_3D = [
    ((32, 8, 128), 16, 2, (0, 0, 0)),
    ((64, 8, 128), 16, 4, (0, 0, 0)),
    ((32, 8, 128), 16, 2, (3, 1, 1)),  # odd sum(lo): the other parity
]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kinds", list(KINDS))
@pytest.mark.parametrize("case", WAVE_3D,
                         ids=["s2", "s4", "s2_odd_lo"])
def test_wavefront_matches_jax_3d(case, kinds, dt):
    shape, bx, nsweeps, lo = case
    npdt, atol, rtol = DTYPES[dt]
    u, rhs, a = fields(shape, npdt, seed=1)
    kw = dict(nsweeps=nsweeps, kinds=KINDS[kinds], lo=lo, **KW)
    ref = jwf.wavefront_relax(jnp.asarray(u), jnp.asarray(rhs),
                              jnp.asarray(a), bx=bx, interpret=True, **kw)
    before = kernel_counts.PLAIN_CALLS["wavefront_relax"]
    out = twf.wavefront_relax(torch.from_numpy(u), torch.from_numpy(rhs),
                              torch.from_numpy(a), **kw)
    # a CPU tensor takes the plain version, and counts it as such
    assert kernel_counts.PLAIN_CALLS["wavefront_relax"] == before + 1
    assert kernel_counts.LAUNCHES["wavefront_relax"] == 0
    close(out, ref, atol, rtol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kinds", ["dirichlet", "mixed", "cf"])
@pytest.mark.parametrize("lo", [(0, 0, 0), (2, 0, 1)], ids=["lo0", "odd_lo"])
def test_wavefront_matches_jax_flat(kinds, lo, dt):
    """The flattened-layout twin computes the same function: the one port
    kernel is its counterpart too."""
    npdt, atol, rtol = DTYPES[dt]
    u, rhs, a = fields((32, 12, 32), npdt, seed=2)
    kw = dict(nsweeps=4, kinds=KINDS[kinds], lo=lo, **KW)
    ref = jwf.wavefront_relax_flat(jnp.asarray(u), jnp.asarray(rhs),
                                   jnp.asarray(a), bx=16, interpret=True,
                                   **kw)
    out = twf.wavefront_relax(torch.from_numpy(u), torch.from_numpy(rhs),
                              torch.from_numpy(a), **kw)
    close(out, ref, atol, rtol)


def test_wavefront_plain_is_the_gsrb_function():
    """wavefront_relax and gsrb_relax compute one function: their plain
    versions share a body, so on the CPU they agree bitwise."""
    u, rhs, a = (torch.from_numpy(x)
                 for x in fields((12, 10, 8), np.float32, seed=3))
    kw = dict(nsweeps=2, kinds=KINDS["mixed"], lo=(1, 0, 0), **KW)
    assert torch.equal(twf.wavefront_relax_plain(u, rhs, a, **kw),
                       tfs.gsrb_relax_plain(u, rhs, a, None, **kw))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kinds", ["dirichlet", "mixed", "cf"])
@pytest.mark.parametrize("shape", [(8, 8, 128), (16, 16, 128)],
                         ids=["8x8x128", "16x16x128"])
def test_residual_matches_jax_one_pass(shape, kinds, dt):
    """`residual` is the counterpart of pallas_kernels.residual (the JAX
    package's residual at levels too big to stay resident) as well as of
    fused_sweeps.resident_residual."""
    npdt, atol, rtol = DTYPES[dt]
    u, rhs, a = fields(shape, npdt, seed=4)
    ref = jpk.residual(jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a),
                       kinds=KINDS[kinds], rho=2.0, alpha=1.0, beta=-1.0,
                       dx=0.25, interpret=True)
    out = tfs.residual(torch.from_numpy(u), torch.from_numpy(rhs),
                       torch.from_numpy(a), None, kinds=KINDS[kinds],
                       rho=2.0, alpha=1.0, beta=-1.0, dx=0.25)
    # f64: 1e-13 of max|result| (values reach 1e2 at dx = 0.25)
    scale = float(np.max(np.abs(np.asarray(ref))))
    close(out, ref, None if atol is None else atol * max(scale, 1.0), rtol)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    u = torch.zeros((8, 8, 8), dtype=torch.float32)
    kw = dict(kinds=KINDS["dirichlet"], lo=(0, 0, 0), **KW)
    with pytest.raises(ValueError, match="periodic"):
        twf.wavefront_relax(u, u, u, nsweeps=2,
                            **dict(kw, kinds=((PER, PER), (D, D), (D, D))))
    with pytest.raises(ValueError, match="nsweeps"):
        twf.wavefront_relax(u, u, u, nsweeps=3, **kw)


# ------------------------------------------------------------- the rung

CANONICAL_SHAPES = [(64, 64, 64), (96, 80, 80), (128, 80, 80), (176, 64, 64),
                    (272, 80, 80), (512, 96, 96), (960, 144, 144)]
# the rung of each for 4 sweeps of an f32 level on the card: the level's
# four arrays against the 50 MB L2
EXPECTED = ["resident", "resident", "resident", "resident", "resident",
            "wave", "wave"]


def _spec(kinds, smoother="auto"):
    return tmg.LevelMGSpec(
        kinds=kinds, boxes=(Box.from_shape((8, 8, 8)),), dx=(1.0,),
        rho=(2.0,), alpha=1.0, beta=-1.0, nsmooth=4, smoother=smoother)


@pytest.mark.parametrize("shape,rung", list(zip(CANONICAL_SHAPES, EXPECTED))
                         + [((256, 256, 256), "wave")],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_plan_decision_table(shape, rung):
    spec = _spec(KINDS["cf"])
    plan = tmg.plan_for(spec, shape, torch.float32, "cuda", 4)
    if rung == "wave":
        assert plan == [("wave", 2), ("wave", 2)]
        assert tmg.plan_for(spec, shape, torch.float32, "cuda", 2) == [
            ("wave", 2)]
    else:
        assert plan == [("resident", 4)]
    # an odd count, a CPU tensor, variable bCoef, f64, periodic x and the
    # staged smoother never take the wave rung (periodic x takes the
    # multisweep rung where the level exceeds the L2 term)
    assert tmg.plan_for(spec, shape, torch.float32, "cuda", 3) == [
        ("resident", 3)]
    assert tmg.plan_for(_spec(KINDS["cf"], "pallas"), shape, torch.float32,
                        "cpu", 4) == [("resident", 4)]
    assert tmg.plan_for(spec, shape, torch.float32, "cpu", 4) == [("xla", 4)]
    assert tmg.plan_for(spec, shape, torch.float32, "cuda", 4,
                        const_b=False) == [("resident", 4)]
    assert tmg.plan_for(spec, shape, torch.float64, "cuda", 4) == [("xla", 4)]
    per_x = _spec(((PER, PER), (D, D), (D, D)))
    assert tmg.plan_for(per_x, shape, torch.float32, "cuda", 4) == (
        [("multisweep", 2), ("multisweep", 2)] if rung == "wave"
        else [("resident", 4)])
    assert tmg.plan_for(_spec(KINDS["cf"], "xla"), shape, torch.float32,
                        "cuda", 4) == [("xla", 4)]


def test_wavefront_supported_rules():
    k, big = KINDS["cf"], (512, 96, 96)
    assert twf.wavefront_supported(big, 2, k)
    assert twf.wavefront_supported(big, 4, k)
    assert not twf.wavefront_supported(big, 1, k)       # no such chunk
    assert not twf.wavefront_supported(big, 2, None)    # x not proven open
    assert not twf.wavefront_supported(
        big, 2, ((PER, PER), (D, D), (D, D)))           # periodic x
    assert not twf.wavefront_supported(
        (512, 97, 96), 2, ((D, D), (PER, PER), (D, D)))  # odd periodic y
    assert twf.wavefront_supported(
        (512, 96, 96), 2, ((D, D), (PER, PER), (PER, PER)))
    assert not twf.wavefront_supported((272, 80, 80), 2, k)  # fits the L2
    # the same level in f64 is twice the bytes
    assert twf.wavefront_supported((272, 80, 80), 2, k, itemsize=8)
    assert twf.wavefront_plan(big, 4, k) == 2
    assert twf.wavefront_plan(big, 5, k) is None
    assert twf.wavefront_plan(big, 0, k) is None


def test_relax_on_cpu_keeps_the_resident_rung():
    """relax() on a CPU tensor never takes the wave rung, whatever the
    shape: the plan is read from the tensor's device."""
    spec = _spec(KINDS["cf"], "pallas")
    u = torch.zeros((8, 8, 8), dtype=torch.float32)
    assert tmg.relax_kernel_plan(spec, u, 4) == [("resident", 4)]
