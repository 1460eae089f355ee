"""The bf16 tier of the PyTorch port (`smoother_precision = bfloat16`: the
colour passes of gsrb_relax and of the towers in bf16) against the JAX
package's.

JAX side: its Pallas kernels with compute_dtype "bfloat16" in interpret
mode, as the JAX package's own tests run them (tests/test_fused_sweeps.py,
tests/test_coarse_tower.py). Port side: the plain PyTorch versions, which
the wrappers run for CPU tensors; the CUDA kernels are held against these
on the card (chip_smoke.py, kernels phase). Inputs from numpy seeds.

Tolerances. Port against JAX: 0.02 of max|JAX| (about five bf16 ulps at
the largest value): both round the fold and the state to bf16 once and
run the passes in bf16, but XLA may keep a fused chain of bf16 operations
in f32 (excess precision) where each torch operation rounds. Tier against
the f32 sweep (the JAX package's own contract, test_bf16_compute_tier_
tracks_f32): f32 dtype, within 0.05 of max|f32 result|, and not equal.
Paths that take no tier (variable b, batch groups): bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid.geometry import BCSpec as JBC, single_level_geom as jgeom1
from mg_ic_code_tpu.ops import fused_sweeps as jfs
from mg_ic_code_tpu.solver import composite as jcomp
from mg_ic_code_tpu.solver import multigrid as jmg

from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC, single_level_geom as tgeom1
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import composite as tcomp
from mg_ic_code_tpu_torch.solver import multigrid as tmg

from tests.test_forest import forest_cfg, two_patch_geom
from tests.test_torch_composite import J, T
from tests.test_torch_coarse_tower import setup as tower_setup
from tests.test_torch_forest_batching import forest_inputs, port_geom

torch.set_num_threads(1)

D, C, N, P = "dirichlet", "cf", "neumann", "periodic"
BF16 = "bfloat16"
PORT_TOL, CONTRACT_TOL = 0.02, 0.05


def within(out, ref, tol):
    """max|out - ref| <= tol * max|ref| (numpy arrays); returns the ratio."""
    ratio = float(np.abs(out - ref).max() / np.abs(ref).max())
    print(f"reading: {ratio:.2e} of max|ref| (limit {tol})")
    assert ratio <= tol, ratio
    return ratio


def holds_contract(tier, f32, tol=CONTRACT_TOL):
    """The JAX package's contract of the tier against the f32 sweep."""
    assert tier.dtype == np.float32
    print("the tier against f32:", end=" ")
    within(tier, f32, tol)
    assert float(np.abs(tier - f32).max()) > 0  # the tier really ran


# (id, shape, kinds, lo): tests/test_fused_sweeps.py:495's shape and kinds
# (test_bf16_compute_tier_tracks_f32, "resident"), an odd lo on CF faces,
# every axis periodic
RELAX_CASES = [
    ("jax_test_shape", (16, 8, 128), ((D, D), (N, D), (D, N)), (0, 0, 0)),
    ("odd_lo", (12, 10, 8), ((C, C), (C, C), (C, C)), (3, 4, 2)),
    ("all_periodic", (8, 6, 10), ((P, P), (P, P), (P, P)), (0, 0, 0)),
]


@pytest.mark.parametrize("cid,shape,kinds,lo", RELAX_CASES,
                         ids=[c[0] for c in RELAX_CASES])
def test_gsrb_relax_tier_matches_jax(cid, shape, kinds, lo):
    """gsrb_relax (2 sweeps) in the tier against the JAX resident_relax
    with compute_dtype bfloat16. Readings (x86-64 CPU): port against JAX
    1.2e-3 / 3.7e-4 / 0 of max|JAX| (98 / 99.6 / 100 % of the cells
    equal); the JAX tier against its f32 sweep 9.5e-3 / 7.8e-3 / 7.1e-3."""
    rng = np.random.default_rng(3)
    u = rng.standard_normal(shape).astype(np.float32)
    rhs = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    kw = dict(kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.1, lo=lo)
    ju, jr, ja = jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a)
    ref = np.asarray(jfs.resident_relax(ju, jr, ja, nsweeps=2,
                                        compute_dtype=BF16, interpret=True,
                                        **kw))
    ref32 = np.asarray(jfs.resident_relax(ju, jr, ja, nsweeps=2,
                                          interpret=True, **kw))
    tu, tr, ta = (torch.from_numpy(x) for x in (u, rhs, a))
    kernel_counts.reset()
    out = tfs.gsrb_relax(tu, tr, ta, nsweeps=2, compute_dtype=BF16, **kw)
    out32 = tfs.gsrb_relax(tu, tr, ta, nsweeps=2, **kw)
    assert kernel_counts.PLAIN_CALLS["gsrb_relax_bf16"] == 1
    assert kernel_counts.PLAIN_CALLS["gsrb_relax"] == 1
    within(out.numpy(), ref, PORT_TOL)
    holds_contract(ref, ref32)
    holds_contract(out.numpy(), out32.numpy())
    # the input is only read
    assert torch.equal(tu, torch.from_numpy(u))


def test_tier_refused_where_it_has_no_form():
    """The wrappers take the tier for f32 levels with constant b only: an
    f64 level or a variable b raises (the path never sends them; a silent
    f32 sweep would hide the fault), as does an unknown compute type. The
    same for the four march wrappers (which take no b): wavefront_relax,
    multisweep_relax and its halo= form, multisweep_relax_tiled_pre, each
    refusing an f64 level and an unknown compute type, each counted under
    its _bf16 name in the tier."""
    from mg_ic_code_tpu_torch.ops import wavefront as twf

    shape = (8, 8, 8)
    kw = dict(nsweeps=1, kinds=((D, D),) * 3, rho=2.0, alpha=1.0,
              beta=-1.0, dx=0.1, lo=(0, 0, 0))
    u = torch.ones(shape)
    with pytest.raises(TypeError, match="bf16 tier"):
        tfs.gsrb_relax(u.double(), u.double(), u.double(),
                       compute_dtype=BF16, **kw)
    with pytest.raises(ValueError, match="constant b"):
        tfs.gsrb_relax(u, u, u, u, compute_dtype=BF16, **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        tfs.gsrb_relax(u, u, u, compute_dtype="float16", **kw)
    assert tfs.tier_name("tower_up", BF16) == "tower_up_bf16"
    assert tfs.tier_name("tower_up", None) == "tower_up"

    mkw = dict(kw, nsweeps=2)
    pads = (torch.ones((8, 8, 8)),) * 3
    pre = torch.ones((16, 16, 8))
    marches = {
        "wavefront_relax": lambda x, **k: twf.wavefront_relax(x, x, x, **k),
        "multisweep_relax": lambda x, **k: tfs.multisweep_relax(x, x, x, **k),
        "multisweep_relax_halo": lambda x, **k: tfs.multisweep_relax(
            x, x, x, halo=tuple(p.to(x.dtype) for p in pads)
            + ((1, 1, 0, 0),), **k),
        "multisweep_relax_tiled_pre": lambda x, **k: (
            tfs.multisweep_relax_tiled_pre(
                pre.to(x.dtype), pre.to(x.dtype), pre.to(x.dtype),
                (1, 1, 0, 0), ny_global=8, **k)),
    }
    for name, call in marches.items():
        with pytest.raises(TypeError, match="bf16 tier"):
            call(u.double(), compute_dtype=BF16, **mkw)
        with pytest.raises(ValueError, match="compute_dtype"):
            call(u, compute_dtype="float16", **mkw)
        kernel_counts.reset()
        out = call(u, compute_dtype=BF16, **mkw)
        assert out.dtype == torch.float32
        assert kernel_counts.PLAIN_CALLS[name + "_bf16"] == 1, name
        assert kernel_counts.PLAIN_CALLS[name] == 0, name


# A V-cycle's tolerances: 4 sweeps down and up at each of 3-4 depths, each
# bf16 pass adding its rounding, and the coarse corrections carrying it up.
# On these inputs the JAX package's own tier reads 0.056 / 0.047 / 0.040 of
# max|f32 V-cycle| against its f32 V-cycle (above the single relax's 0.05 on
# the 32^3 Dirichlet chain), the port's 0.034 / 0.047 / 0.040, and the two
# tiers 0.023 / 0 / 4e-4 of max|JAX| apart (the JAX side leaves ~2 % of the
# cells off the bf16 grid: XLA keeps fused bf16 chains in f32). Held with
# some room to 0.04 (port against JAX) and 0.08 (the port's tier against
# its f32 V-cycle; the JAX package's own against its f32 is that package's
# test, tests/test_coarse_tower.py::test_tower_bf16_tier_tracks_f32).
VCYCLE_PORT_TOL, VCYCLE_CONTRACT_TOL = 0.04, 0.08


@pytest.mark.parametrize("bc,n", [("dirichlet", 32), ("periodic", 16),
                                  ("mixed", 16)])
def test_mg_vcycle_tier_matches_jax(bc, n):
    """mg_vcycle with smoother_compute bfloat16 on the tower path (the
    set-up of tests/test_coarse_tower.py:96, test_tower_bf16_tier_tracks_
    f32: 4 smooths, the chain 32^3 (or 16^3) down to 4^3, the same
    coefficient chain on both sides) against the JAX package's, at the
    tolerances VCYCLE_* states with its readings; the tier really ran
    (the tower's bf16 counters, and it differs from the f32 V-cycle)."""
    jspec, tspec, jco, tco, a, rhs, u0 = tower_setup(bc, n=n)
    jspec_bf = dataclasses.replace(jspec, smoother_compute=BF16)
    tspec_bf = dataclasses.replace(tspec, smoother_compute=BF16)
    ju, jr = jnp.asarray(u0), jnp.asarray(rhs)
    ref = np.asarray(jmg.mg_vcycle_jit(jspec_bf, jco, ju, jr))
    tu, tr = torch.from_numpy(u0), torch.from_numpy(rhs)
    kernel_counts.reset()
    out = tmg.mg_vcycle(tspec_bf, tco, tu, tr).numpy()
    plain = dict(kernel_counts.PLAIN_CALLS)
    assert plain["tower_down_bf16"] == plain["tower_up_bf16"] == 1
    assert plain["tower_down"] == plain["tower_up"] == 0
    out32 = tmg.mg_vcycle(tspec, tco, tu, tr).numpy()
    within(out, ref, VCYCLE_PORT_TOL)
    holds_contract(out, out32, VCYCLE_CONTRACT_TOL)


def level(n=16, seed=5):
    rng = np.random.default_rng(seed)
    spec = tmg.make_level_spec(tgeom1(n, 1.0, TBC()), 0, alpha=1.0,
                               beta=-1.0, nsmooth=4, smoother="pallas")
    f = {k: torch.from_numpy(rng.standard_normal((n,) * 3).astype(np.float32))
         for k in ("u", "rhs")}
    for k in ("a", "b"):
        f[k] = torch.from_numpy(
            rng.uniform(0.5, 2.0, (n,) * 3).astype(np.float32))
    return spec, dataclasses.replace(spec, smoother_compute=BF16), f


def test_variable_b_and_batch_groups_take_no_tier():
    """multigrid.relax under the tier sweeps a level with variable b at f32
    (the JAX package's variable-b resident call takes no compute dtype),
    and relax_batch sweeps a batch group at f32 (the JAX package's
    vmapped relax_xla): both bit for bit the f32 spec's result; a constant
    b level does take the tier."""
    spec, spec_bf, f = level()
    for b in (f["b"], None):
        coefs = tmg.build_level_coefs(spec, f["a"], b)
        kernel_counts.reset()
        out = tmg.relax(spec_bf, coefs, 0, f["u"], f["rhs"], 4)
        tier = dict(kernel_counts.PLAIN_CALLS)
        ref = tmg.relax(spec, coefs, 0, f["u"], f["rhs"], 4)
        if b is not None:
            assert torch.equal(out, ref)
            assert tier["gsrb_relax"] == 1 and tier["gsrb_relax_bf16"] == 0
        else:
            holds_contract(out.numpy(), ref.numpy())
            assert tier["gsrb_relax_bf16"] == 1 and tier["gsrb_relax"] == 0
    coefs = tmg.build_level_coefs(spec, f["a"])
    us, rhss = [f["u"], f["rhs"]], [f["rhs"], f["u"]]
    kernel_counts.reset()
    out = tmg.relax_batch([spec_bf] * 2, [coefs] * 2, 0, us, rhss, 4)
    assert kernel_counts.PLAIN_CALLS["gsrb_relax_batch"] == 1
    ref = tmg.relax_batch([spec] * 2, [coefs] * 2, 0, us, rhss, 4)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))


def test_force_forest_precond_tier_matches_jax():
    """The preconditioner (two AMR V-cycles, f32, kernel path) of the
    forest under forest_batching = force in the tier, against the JAX
    package's: the pair swept as one batch at f32 (gsrb_relax_batch; the
    JAX package's vmapped relax_xla), the base chain in the towers and the
    grandchild by gsrb_relax in bf16, no f32 gsrb_relax call. Readings:
    port against JAX 7.9e-5 / 2.6e-5 / 1.5e-5 / 1.8e-4 of each level's
    max|JAX| (limit 0.02); the port's tier against its f32 preconditioner
    within 0.05 and not equal, level by level."""
    jg = two_patch_geom(n=16, depth2=True)
    a, r = forest_inputs(jg, seed=7)
    outs = {}
    for prec in (BF16, "auto"):
        cfg = forest_cfg(n_cells=(16, 16, 16), max_level=2,
                         forest_batching="force", smoother="pallas",
                         precond_precision="single", smoother_precision=prec)
        tspec = tcomp.make_amr_spec(port_geom(jg), TCfg(
            **{f.name: getattr(cfg, f.name)
               for f in dataclasses.fields(TCfg)}), device="cpu")
        assert tspec.batch_groups == ((1, 2),)
        assert all(ls.smoother_compute == (BF16 if prec == BF16 else None)
                   for ls in tspec.level_specs)
        kernel_counts.reset()
        outs[prec] = ([x.numpy() for x in tcomp.precond(
            tspec, tcomp.build_coefs(tspec, T(a)), T(r))],
            dict(kernel_counts.PLAIN_CALLS))
        if prec == BF16:
            jspec = jcomp.make_amr_spec(jg, cfg)
            assert jspec.batch_groups == ((1, 2),)
            ref = [np.asarray(x) for x in jcomp.precond_jit(
                jspec, jcomp.build_coefs_jit(jspec, J(a)), J(r))]
    (out, calls), (out32, _) = outs[BF16], outs["auto"]
    assert calls["gsrb_relax_batch"] == 4 and calls["gsrb_relax"] == 0
    assert calls["gsrb_relax_bf16"] > 0 and calls["tower_down_bf16"] == 2
    for t, j, t32 in zip(out, ref, out32):
        within(t, j, PORT_TOL)
        assert float(np.abs(t - t32).max()) > 0
        assert float(np.abs(t - t32).max()) <= (
            CONTRACT_TOL * float(np.abs(t32).max()))


def test_smoother_precision_config_resolution():
    """The port of tests/test_fused_sweeps.py::test_smoother_precision_
    config_resolution: cfg.smoother_precision goes through make_amr_spec
    into every level spec's smoother_compute; auto and single resolve to
    the operands' precision (None), bfloat16 to "bfloat16"; the JAX
    package's spec says the same."""
    jgeom = jgeom1(16, 1.0, JBC())
    tgeom = tgeom1(16, 1.0, TBC())
    base = dict(alpha=1.0, beta=-1.0, L=16.0, n_cells=(16, 16, 16),
                max_level=0, num_mg_smooth=2, num_mg_iterations=1,
                max_iterations=4, max_nl_iterations=1, tolerance=1e-8)
    for prec, want in (("auto", None), ("single", None), (BF16, BF16)):
        jspec = jcomp.make_amr_spec(jgeom, JCfg(smoother_precision=prec,
                                                **base))
        for precond in ("auto", "single"):
            tspec = tcomp.make_amr_spec(tgeom, TCfg(
                smoother_precision=prec, precond_precision=precond, **base),
                device="cpu")
            assert all(ls.smoother_compute == want
                       for ls in tspec.level_specs), (prec, precond)
        assert jspec.level_specs[0].smoother_compute == want


def test_small_bbh_precond_tier_matches_jax():
    """One preconditioner application (composite.precond: two AMR V-cycles,
    f32, the kernel path) in the tier on the small BBH hierarchy of
    tests/test_torch_nonlinear.py (two levels, no batch groups: the refined
    level's relax a gsrb_relax call in bf16, the base chain in the towers)
    against the JAX package's precond on the same hierarchy (the JAX
    tagging's, converted) and the same inputs: the first Picard iteration's
    aCoef and rhs of the port's initial state. Port against JAX within 0.02
    of each level's max|JAX| (read 3.1e-6 and 0); the port's tier against
    its f32 preconditioner within 0.05 and not equal, level by level (read
    0.023 and 0.0043). ~45 s here, most of it the JAX interpret-mode
    compilation."""
    from mg_ic_code_tpu.grid.tagging import generate_hierarchy as jgen
    from mg_ic_code_tpu_torch.physics import level_data as tld
    from mg_ic_code_tpu_torch.solver import nonlinear as tnl
    from tests.test_torch_nonlinear import small_bbh_kw

    outs = {}
    for prec in (BF16, "auto"):
        kw = small_bbh_kw(precond_precision="single", smoother="pallas",
                          average_down=1, smoother_precision=prec)
        jcfg, tcfg = JCfg(**kw), TCfg(**kw)
        if prec == BF16:
            jg = jgen(jcfg)
            tg = port_geom(jg)
            fields = [tld.problem_fields(tg, tcfg, l, torch.float64, "cpu")
                      for l in range(tg.num_levels)]
            psi = tld.initial_state(tg, tcfg, torch.float64, "cpu")["psi"]
            a, r, _ = tnl.prepare_iteration(tg, tcfg, fields, psi)
            a, r = [x.numpy() for x in a], [x.numpy() for x in r]
        tspec = tcomp.make_amr_spec(tg, tcfg, device="cpu")
        assert not tspec.batch_groups
        kernel_counts.reset()
        outs[prec] = ([x.numpy() for x in tcomp.precond(
            tspec, tcomp.build_coefs(tspec, T(a)), T(r))],
            dict(kernel_counts.PLAIN_CALLS))
        if prec == BF16:
            jspec = jcomp.make_amr_spec(jg, jcfg)
            assert all(ls.smoother_compute == BF16
                       for ls in jspec.level_specs)
            ref = [np.asarray(x) for x in jcomp.precond_jit(
                jspec, jcomp.build_coefs_jit(jspec, J(a)), J(r))]
    (out, calls), (out32, _) = outs[BF16], outs["auto"]
    assert calls["gsrb_relax"] == calls["tower_down"] == 0
    assert all(calls[k] > 0 for k in ("gsrb_relax_bf16", "tower_down_bf16",
                                      "tower_up_bf16"))
    assert len(out) == len(ref) == 2
    for t, j, t32 in zip(out, ref, out32):
        within(t, j, PORT_TOL)
        print("the tier against f32:", end=" ")
        within(t, t32, CONTRACT_TOL)
        assert float(np.abs(t - t32).max()) > 0


def test_two_level_solve_tier():
    """A two-level poisson_solve with smoother = pallas, the f32
    preconditioner and the tier on the CPU (tests/test_torch_nonlinear.py's
    small BBH configuration), beside the live comparison of one
    preconditioner application (test_small_bbh_precond_tier_matches_jax).
    The JAX package's interpret-mode solve of the same configuration takes
    ~67 s here, so this test holds the port's run to that solve's
    readings (x86-64 CPU, 3 Picard entries: 0.024840428
    41098881, 1.8241309e-05, 1.5302337e-05; Krylov 3, 3, 2): entry 1 to
    1e-6 relative, the others (above 1e-6) to 1e-3, Krylov within one. The
    port read 0.024840428
    86794670, 1.8243952e-05, 1.5293784e-05, Krylov 3, 3, 3. The tier
    stalls the Picard history at ~1.5e-5 where the f32 preconditioner
    reaches 1.6e-8 in three entries, in both packages: BiCGStab with a
    preconditioner rounded at bf16 stops near its accuracy."""
    from mg_ic_code_tpu_torch.solver import nonlinear as tnl
    from tests.test_torch_nonlinear import small_bbh_kw

    jax_h = (0.024840428410988807, 1.8241309489067068e-05,
             1.530233679847466e-05)
    jax_k = (3, 3, 2)
    kw = small_bbh_kw(precond_precision="single", smoother="pallas",
                      max_nl_iterations=3, smoother_precision=BF16)
    kernel_counts.reset()
    res = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    h = res.dpsi_norm_history
    assert len(h) == 3
    assert abs(h[0] - jax_h[0]) <= 1e-6 * jax_h[0]
    assert all(abs(x - y) <= 1e-3 * y for x, y in zip(h[1:], jax_h[1:]))
    assert all(abs(x - y) <= 1 for x, y in zip(res.linear_iters, jax_k))
    plain = kernel_counts.PLAIN_CALLS
    assert all(plain[k] > 0 for k in ("gsrb_relax_bf16", "tower_down_bf16",
                                      "tower_up_bf16"))
    assert plain["gsrb_relax"] == plain["tower_down"] == 0
