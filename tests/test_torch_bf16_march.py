"""The bf16 tier of the marches (`smoother_precision = bfloat16` on the wave
and multisweep rungs and at the depths a mesh cuts) against the JAX
package's fused families, and the port's routing of the tier.

JAX side: its Pallas kernels with compute_dtype "bfloat16" in interpret
mode, as the JAX package's own tests run them (tests/test_fused_sweeps.py::
test_bf16_compute_tier_tracks_f32, tests/test_wavefront.py::
test_wavefront_bf16_tier_tracks_f32). Port side: the plain PyTorch versions,
which the wrappers run for CPU tensors; the CUDA kernels are held bit for
bit to their twins on the card (chip_smoke.py, kernels phase). Inputs from
numpy seeds.

Tolerances: the JAX package's contract of each family, of max|JAX|: 0.05,
0.1 for the wavefront ("the carry rows round-trip through the f32 scratch",
and its bf16 x ghost row, which the port folds instead). The port's tier
against its own f32 form at the same contract: f32 dtype, within the limit,
not equal. Paths that take no tier: bit for bit the f32 result. The joined
sharded relax against the whole-level plain version: bit for bit."""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.ops import coarse_tower as jct
from mg_ic_code_tpu.ops import fused_sweeps as jfs
from mg_ic_code_tpu.ops import wavefront as jwf
from mg_ic_code_tpu.solver import composite as jcomp
from mg_ic_code_tpu.solver import multigrid as jmg

import mg_ic_code_tpu_torch as mgt
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.ops import wavefront as twf
from mg_ic_code_tpu_torch.parallel import halo as thalo
from mg_ic_code_tpu_torch.parallel import mesh as tmesh
from mg_ic_code_tpu_torch.solver import composite as tcomp
from mg_ic_code_tpu_torch.solver import multigrid as tmg

from tests.test_torch_bf16_tier import holds_contract, within
from tests.test_torch_coarse_tower import setup as tower_setup
from tests.test_torch_composite import J, T
from tests.test_torch_forest_batching import port_geom
from tests.test_torch_parallel import (
    HALO_CASES, PRE_CASES, _kernel_spec, _kinds, _mesh_pair, _pads, _t,
)

torch.set_num_threads(1)

D, C, N, P = "dirichlet", "cf", "neumann", "periodic"
BF16 = "bfloat16"
FAMILY_TOL, WAVE_TOL = 0.05, 0.1
# tests/test_fused_sweeps.py:495's faces
JAX_KINDS = ((D, D), (N, D), (D, N))


def fields(shape, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    rhs = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return u, rhs, a


# (family, shape, nsweeps, the JAX call, the port's wrapper, the limit):
# each JAX family that computes the function of a port march, at the
# shapes and faces of the JAX package's own bf16 tests (the flat pipelined
# form, which those tests leave out, at the flat form's shape)
FAMILIES = [
    ("wavefront", (32, 8, 128), 4,
     functools.partial(jwf.wavefront_relax, bx=16), "wavefront", WAVE_TOL),
    ("wavefront_flat", (32, 8, 128), 4,
     functools.partial(jwf.wavefront_relax_flat, bx=16), "wavefront",
     WAVE_TOL),
    ("slab", (16, 8, 128), 2, functools.partial(jfs.multisweep_relax, bx=8),
     "multisweep", FAMILY_TOL),
    ("pipelined", (16, 8, 128), 2, jfs.multisweep_relax_pipelined,
     "multisweep", FAMILY_TOL),
    ("flat", (32, 16, 16), 4,
     functools.partial(jfs.multisweep_relax_flat, bx=16), "multisweep",
     FAMILY_TOL),
    ("flat_pipelined", (32, 16, 16), 4, jfs.multisweep_relax_flat_pipelined,
     "multisweep", FAMILY_TOL),
    ("tiled", (32, 32, 128), 2,
     functools.partial(jfs.multisweep_relax_tiled, bx=8, by=8),
     "multisweep", FAMILY_TOL),
]


@pytest.mark.parametrize("family,shape,ns,jcall,port,tol", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_march_tier_matches_jax_families(family, shape, ns, jcall, port,
                                         tol):
    """wavefront_relax / multisweep_relax in the tier (their plain
    versions, counted under *_bf16) against each JAX family of the same
    function with compute_dtype bfloat16, at that family's contract of
    max|JAX|; the port's tier against its f32 form at the same contract.
    Readings (x86-64 CPU), port against JAX: wavefront 3.9e-2,
    wavefront_flat 3.9e-2, slab 1.2e-2, pipelined 1.2e-2, flat 2.1e-2,
    flat_pipelined 2.1e-2, tiled 1.1e-2 of max|JAX|."""
    u, rhs, a = fields(shape, seed=3)
    kw = dict(kinds=JAX_KINDS, rho=2.0, alpha=1.0, beta=-1.0, dx=0.1,
              lo=(0, 0, 0), nsweeps=ns)
    ref = np.asarray(jcall(jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a),
                           compute_dtype=BF16, interpret=True, **kw))
    assert ref.dtype == np.float32
    fn = twf.wavefront_relax if port == "wavefront" else tfs.multisweep_relax
    kernel_counts.reset()
    out = fn(_t(u), _t(rhs), _t(a), compute_dtype=BF16, **kw).numpy()
    out32 = fn(_t(u), _t(rhs), _t(a), **kw).numpy()
    name = "wavefront_relax" if port == "wavefront" else "multisweep_relax"
    assert kernel_counts.PLAIN_CALLS[name + "_bf16"] == 1
    assert kernel_counts.PLAIN_CALLS[name] == 1
    print(f"{family}: port against JAX", end=" ")
    within(out, ref, tol)
    holds_contract(out, out32, tol)


@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("case", HALO_CASES, ids=[c[0] for c in HALO_CASES])
def test_halo_tier_matches_jax(case, nsweeps):
    """multisweep_relax(halo=...) in the tier (its plain version, counted
    under multisweep_relax_halo_bf16) against the JAX kernel's halo form
    with compute_dtype bfloat16 on the same pads and meta (tests/
    test_torch_parallel.py's cases), within 0.05 of max|JAX|; the tier
    against the port's f32 halo form at the same contract."""
    label, meta, bc = case
    shape, H = (16, 8, 16), 2 * nsweeps
    u, rhs, a = fields(shape, seed=21)
    kinds = _kinds(bc)
    pads = _pads(np.random.default_rng(23), u, H, np.float32, meta, kinds)
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.37, lo=(1, 0, 2))
    ref = np.asarray(jfs.multisweep_relax(
        jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a), bx=8,
        interpret=True, compute_dtype=BF16,
        halo=tuple(jnp.asarray(p) for p in pads)
        + (jnp.asarray(meta, jnp.int32),), **kw))
    halo = tuple(_t(p) for p in pads) + (meta,)
    kernel_counts.reset()
    out = tfs.multisweep_relax(_t(u), _t(rhs), _t(a), halo=halo,
                               compute_dtype=BF16, **kw).numpy()
    out32 = tfs.multisweep_relax(_t(u), _t(rhs), _t(a), halo=halo,
                                 **kw).numpy()
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_halo_bf16"] == 1
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_halo"] == 1
    print(f"{label}: port against JAX", end=" ")
    within(out, ref, FAMILY_TOL)
    holds_contract(out, out32)


@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("case", PRE_CASES, ids=[c[0] for c in PRE_CASES])
def test_tiled_pre_tier_matches_jax(case, nsweeps):
    """multisweep_relax_tiled_pre in the tier (counted under
    multisweep_relax_tiled_pre_bf16) against the JAX kernel with
    compute_dtype bfloat16 on the same prepadded operands and meta, within
    0.05 of max|JAX|; the tier against the port's f32 form likewise."""
    label, meta, ny_global, bc = case
    nx, ny, nz, H = 8, 8, 128, 2 * nsweeps
    u, rhs, a = fields((nx + 2 * H, ny + 2 * H, nz), seed=22)
    kinds = _kinds(bc)
    if kinds[0][0] != P:  # the contract at a domain x face
        from mg_ic_code_tpu.ops.ghosts import ghost_plane

        if meta[0]:
            u[:H] = np.asarray(ghost_plane(kinds[0][0], u[H:H + 1],
                                           u[H + 1:H + 2], 2.0))
        if meta[1]:
            u[H + nx:] = np.asarray(ghost_plane(
                kinds[0][1], u[H + nx - 1:H + nx],
                u[H + nx - 2:H + nx - 1], 2.0))
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.37, lo=(0, 1, 0), ny_global=ny_global)
    ref = np.asarray(jfs.multisweep_relax_tiled_pre(
        jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a),
        jnp.asarray(meta, jnp.int32), bx=8, by=8, interpret=True,
        compute_dtype=BF16, **kw))
    kernel_counts.reset()
    out = tfs.multisweep_relax_tiled_pre(_t(u), _t(rhs), _t(a), meta,
                                         compute_dtype=BF16, **kw).numpy()
    out32 = tfs.multisweep_relax_tiled_pre(_t(u), _t(rhs), _t(a), meta,
                                           **kw).numpy()
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_tiled_pre_bf16"] == 1
    assert out.shape == (nx, ny, nz)
    print(f"{label}: port against JAX", end=" ")
    within(out, ref, FAMILY_TOL)
    holds_contract(out, out32)


@pytest.mark.parametrize("mshape,shape,kernel", [
    (None, (64, 8, 128), "multisweep_relax_halo"),
    ((4, 2), (32, 32, 128), "multisweep_relax_tiled_pre"),
], ids=["x_slabs", "pencils"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_sharded_tier_is_the_whole_level_tier(bc, mshape, shape, kernel):
    """The sharded relax in the tier on a CPU mesh (8 x-slabs, or (4, 2)
    pencils: every shard's plain version, counted under the shard march's
    _bf16 name) joined is bit for bit the whole-level bf16 plain version
    (the seams' halo recompute gives every kept cell the whole level's
    update); it is within 0.05 of the JAX package's sharded relax in the
    tier, and it differs from the port's f32 sharded relax within the
    contract."""
    jm, tm = _mesh_pair(mshape)
    js, ts = _kernel_spec(jm, tm, shape, bc)
    js = dataclasses.replace(js, smoother_compute=BF16)
    ts_bf = dataclasses.replace(ts, smoother_compute=BF16)
    u0, rhs, a = fields(shape, seed=31)
    tc = tmg.build_level_coefs(ts, _t(a))
    kernel_counts.reset()
    out = tmg.relax(ts_bf, tc, 0, _t(u0), _t(rhs), 4)
    assert kernel_counts.PLAIN_CALLS[kernel + "_bf16"] == 16
    assert kernel_counts.PLAIN_CALLS[kernel] == 0
    whole = tfs.gsrb_sweeps_folded(
        _t(u0), _t(rhs), _t(a), None, nsweeps=4, kinds=ts.kinds, rho=2.0,
        alpha=1.0, beta=-1.0, dx=1.0 / shape[0], lo=(0, 0, 0),
        compute_dtype=BF16)
    assert torch.equal(out, whole)
    jc = jmg.build_level_coefs(js, jnp.asarray(a))
    spec = jax.sharding.PartitionSpec("x", "y" if mshape else None)
    sh = jax.sharding.NamedSharding(jm, spec)
    ref = np.asarray(jmg.relax_jit(js, jc, 0, jax.device_put(u0, sh),
                                   jax.device_put(rhs, sh), 4))
    print(f"{bc}: port against JAX", end=" ")
    within(out.numpy(), ref, FAMILY_TOL)
    holds_contract(out.numpy(), tmg.relax(ts, tc, 0, _t(u0), _t(rhs),
                                          4).numpy())


def test_batch_groups_and_plain_sharded_routes_take_no_tier(monkeypatch):
    """What the JAX package leaves at f32 the port leaves at f32, bit for
    bit the f32 spec's result: a batch group on a march rung (relax_batch,
    one march launch a patch at f32: the JAX package's vmapped relax_xla),
    and the plain sharded routes (halo._route "slab_plain" for an odd sweep
    count, "block_plain" for variable b: the JAX package's XLA fallbacks)
    under the tier; the march rung itself takes it."""
    n = 16
    spec = tmg.LevelMGSpec(
        kinds=((P, P), (D, D), (D, D)), boxes=(Box.from_shape((n, n, n)),),
        dx=(1.0 / n,), rho=(2.0,), alpha=1.0, beta=-1.0,
        nsmooth=4, smoother="pallas")
    spec_bf = dataclasses.replace(spec, smoother_compute=BF16)
    u, rhs, a = (_t(x) for x in fields((n, n, n), seed=5))
    b = _t(np.random.default_rng(6).uniform(0.5, 2.0, (n, n, n))
           .astype(np.float32))
    # the card's dispatch on CPU tensors, 16^3 above a lowered L2 size term
    monkeypatch.setattr(tfs, "L2_BYTES", 32 << 10)
    monkeypatch.setattr(tmg, "relax_kernel_plan", lambda s, x, k, const_b=(
        True): tmg.plan_for(s, x.shape, x.dtype, "cuda", k, const_b))
    assert tmg.relax_kernel_plan(spec, u, 4) == [("multisweep", 2)] * 2
    coefs = tmg.build_level_coefs(spec, a)
    kernel_counts.reset()
    out = tmg.relax_batch([spec_bf] * 2, [coefs] * 2, 0, [u, rhs],
                          [rhs, u], 4)
    assert kernel_counts.PLAIN_CALLS["multisweep_relax"] == 4
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_bf16"] == 0
    ref = tmg.relax_batch([spec] * 2, [coefs] * 2, 0, [u, rhs], [rhs, u], 4)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    kernel_counts.reset()
    tier = tmg.relax(spec_bf, coefs, 0, u, rhs, 4)
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_bf16"] == 2
    holds_contract(tier.numpy(), tmg.relax(spec, coefs, 0, u, rhs, 4).numpy())

    mesh = tmesh.make_mesh(["cpu"] * 2)
    sspec = dataclasses.replace(spec, mesh=mesh)
    sspec_bf = dataclasses.replace(sspec, smoother_compute=BF16)
    for nsw, bb, route in ((3, None, "slab_plain"), (4, b, "block_plain")):
        assert thalo._route(sspec_bf, 0, bb is None, torch.float32, "cpu",
                            nsw) == route
        sc = tmg.build_level_coefs(sspec, a, bb)
        kernel_counts.reset()
        out = tmg.relax(sspec_bf, sc, 0, u, rhs, nsw)
        assert all(v == 0 for v in kernel_counts.PLAIN_CALLS.values())
        assert torch.equal(out, tmg.relax(sspec, sc, 0, u, rhs, nsw)), route


def _jax_sharded_tier(loc, n: int, pencil: bool) -> bool:
    """Whether the JAX package's sharded relax keeps the tier at a local
    shard shape: its kernel plan there (parallel/halo.py:428-439 for
    x-slabs, :601 for pencils) or its XLA fallback, which takes none."""
    if pencil:
        return n % 2 == 0 and jfs.tiled_plan(loc, min(n, 4)) is not None
    plan = jmg._slab_plan(loc, n)
    return (plan is not None and not plan[2]) or (
        n % 2 == 0 and jfs.tiled_plan(loc, min(n, 4)) is not None)


def test_sharded_tier_route_against_the_jax_rule():
    """The port's rule (halo._route): every depth a mesh cuts on the
    card's paths (the periodic box on 4 x-slabs and on (2, 2) pencils,
    scale7 on 4 x-slabs) runs the shard marches, so the tier. The JAX
    package's sharded path keeps it only where its TPU tiling plan holds
    and falls back to its untiered XLA body elsewhere; at these shapes the
    two give the same tier only at the box's 256^3 and 128^3 depths."""
    params = mgt.__path__[0] + "/params/"
    same, differ = [], []
    for name, fname, over, mshape in (
            ("box_x", "periodic.txt", [], (4,)),
            ("box_pencil", "periodic.txt", [], (2, 2)),
            ("scale7_x", "canonical.txt", ["max_level = 6"], (4,))):
        cfg = mgt.load_params(params + fname, overrides=over + [
            "smoother_precision = bfloat16", "precond_precision = single"])
        mesh = tmesh.make_mesh(["cpu"] * 4, mshape)
        spec = tcomp.make_amr_spec(generate_hierarchy(cfg, device="cpu"),
                                   cfg, device="cpu", mesh=mesh)
        for ls in spec.level_specs:
            assert ls.smoother_compute == BF16
            for d, box in enumerate(ls.boxes):
                counts = tmg._shard_counts(ls, d)
                if counts == (1, 1, 1):
                    continue
                route = thalo._route(ls, d, True, torch.float32, "cuda",
                                     ls.nsmooth)
                assert route in ("slab_kernel", "pencil_kernel"), route
                loc = tuple(s // k for s, k in zip(box.shape, counts))
                key = (name, tuple(box.shape))
                (same if _jax_sharded_tier(loc, ls.nsmooth, counts[1] > 1)
                 else differ).append(key)
    assert sorted(same) == sorted(
        (b, (s,) * 3) for b in ("box_x", "box_pencil") for s in (256, 128))
    assert len(differ) == 2 + 3 + 8


# The V-cycle and preconditioner tests force the march rungs at CPU sizes:
# the port's dispatch as on the card (plan_for with "cuda") with the L2 size
# term lowered, and the JAX package's resident (and tower) plans refused
# above a cell count, so that both sweep the same depths with their
# marches in the tier.
def march_rungs(monkeypatch, l2_bytes: int, cells: int):
    monkeypatch.setattr(tfs, "L2_BYTES", l2_bytes)
    monkeypatch.setattr(tmg, "relax_kernel_plan", lambda s, x, k, const_b=(
        True): tmg.plan_for(s, x.shape, x.dtype, "cuda", k, const_b))
    resident, tower = jfs.resident_supported, jct.tower_supported
    monkeypatch.setattr(
        jfs, "resident_supported", lambda shape, extra_arrays=0: (
            math.prod(shape) < cells
            and resident(shape, extra_arrays=extra_arrays)))
    monkeypatch.setattr(
        jct, "tower_supported", lambda spec, coefs, d: (
            math.prod(spec.boxes[d].shape) < cells
            and tower(spec, coefs, d)))


# The V-cycle's tolerance (tests/test_torch_bf16_tier.py's
# VCYCLE_CONTRACT_TOL): 4 sweeps down and up at each depth, each bf16 pass
# adding its rounding. On the march rungs the port is held to the JAX
# package at the same limit: the JAX flat pipelined family's bf16
# arithmetic is not its resident body's (one call of 4 sweeps on the
# periodic 16^3 level leaves 60 % of the cells off the resident body's
# values, 1.05e-2 of max, where the port and the JAX resident body agree
# bit for bit), and the V-cycle carries that drift into its result.
VCYCLE_CONTRACT_TOL = 0.08


def test_periodic_chain_vcycle_tier_matches_jax(monkeypatch):
    """mg_vcycle in the tier on the periodic 16^3 chain with its top depth
    on the multisweep rung (the JAX package's flat pipelined family; the
    port's multisweep_relax_bf16: two launches of 2 sweeps before and after
    the coarse correction), 8^3 and the 4^3 bottom's pre-smooth on
    gsrb_relax's tier: against the JAX package's V-cycle and the port's
    tier against its f32 V-cycle, both within VCYCLE_CONTRACT_TOL.
    Readings (x86-64 CPU): port against JAX 4.65e-2 of max|JAX|, the tier
    against f32 4.68e-2."""
    jspec, tspec, jco, tco, a, rhs, u0 = tower_setup("periodic", n=16)
    march_rungs(monkeypatch, 32 << 10, 16 ** 3)
    jspec_bf = dataclasses.replace(jspec, smoother_compute=BF16)
    tspec_bf = dataclasses.replace(tspec, smoother_compute=BF16)
    assert jmg.relax_kernel_plan((16,) * 3, 4, jspec.kinds)[0][0] == "flatp"
    assert not jct.tower_supported(jspec, jco, 0)
    ref = np.asarray(jax.jit(functools.partial(jmg.mg_vcycle, jspec_bf))(
        jco, jnp.asarray(u0), jnp.asarray(rhs)))
    tu, tr = torch.from_numpy(u0), torch.from_numpy(rhs)
    kernel_counts.reset()
    out = tmg.mg_vcycle(tspec_bf, tco, tu, tr).numpy()
    plain = dict(kernel_counts.PLAIN_CALLS)
    assert plain["multisweep_relax_bf16"] == 4
    assert plain["gsrb_relax_bf16"] == 3
    assert plain["multisweep_relax"] == plain["gsrb_relax"] == 0
    out32 = tmg.mg_vcycle(tspec, tco, tu, tr).numpy()
    within(out, ref, VCYCLE_CONTRACT_TOL)
    holds_contract(out, out32, VCYCLE_CONTRACT_TOL)


def test_bbh_3level_precond_tier_matches_jax(monkeypatch):
    """One preconditioner application in the tier on the 3-level small BBH
    hierarchy (tests/test_torch_nonlinear.py's configuration at max_level
    2: 16^3, 24x16x16, 32x16x16), its refined levels on the wave rung (the
    JAX package's flat wavefront family; the port's wavefront_relax_bf16),
    the base chain in the towers' tier: against the JAX package's, within
    0.02 of each level's max|JAX|, and the port's tier against its f32
    preconditioner within VCYCLE_CONTRACT_TOL (two V-cycles of bf16
    passes: the base level reads above the single relax's 0.05, as the
    JAX package's own tier does against its f32 V-cycle) and not equal,
    level by level. Readings (x86-64 CPU): port against JAX 6.5e-3 /
    9.8e-3 / 2.6e-3, the tier against f32 5.6e-2 / 4.0e-2 / 2.2e-2."""
    from mg_ic_code_tpu.grid.tagging import generate_hierarchy as jgen
    from mg_ic_code_tpu_torch.physics import level_data as tld
    from mg_ic_code_tpu_torch.solver import nonlinear as tnl
    from tests.test_torch_nonlinear import small_bbh_kw

    march_rungs(monkeypatch, 64 << 10, 16 ** 3 + 1)
    outs = {}
    for prec in (BF16, "auto"):
        kw = small_bbh_kw(precond_precision="single", smoother="pallas",
                          average_down=1, max_level=2,
                          smoother_precision=prec)
        jcfg, tcfg = JCfg(**kw), TCfg(**kw)
        if prec == BF16:
            jg = jgen(jcfg)
            tg = port_geom(jg)
            fields_ = [tld.problem_fields(tg, tcfg, lv, torch.float64, "cpu")
                       for lv in range(tg.num_levels)]
            psi = tld.initial_state(tg, tcfg, torch.float64, "cpu")["psi"]
            a, r, _ = tnl.prepare_iteration(tg, tcfg, fields_, psi)
            a, r = [x.numpy() for x in a], [x.numpy() for x in r]
        tspec = tcomp.make_amr_spec(tg, tcfg, device="cpu")
        assert [tuple(b.shape) for b in tspec.geom.boxes] == [
            (16, 16, 16), (24, 16, 16), (32, 16, 16)]
        kernel_counts.reset()
        outs[prec] = ([x.numpy() for x in tcomp.precond(
            tspec, tcomp.build_coefs(tspec, T(a)), T(r))],
            dict(kernel_counts.PLAIN_CALLS))
        if prec == BF16:
            jspec = jcomp.make_amr_spec(jg, jcfg)
            for ls in jspec.level_specs[1:]:
                assert jmg.relax_kernel_plan(ls.boxes[0].shape, 4,
                                             ls.kinds)[0][0] == "wavef"
            ref = [np.asarray(x) for x in jax.jit(functools.partial(
                jcomp.precond, jspec))(jcomp.build_coefs_jit(jspec, J(a)),
                                       J(r))]
    (out, calls), (out32, _) = outs[BF16], outs["auto"]
    assert calls["wavefront_relax_bf16"] > 0 and calls["tower_down_bf16"] > 0
    assert calls["wavefront_relax"] == calls["gsrb_relax"] == 0
    assert len(out) == len(ref) == 3
    for t, j, t32 in zip(out, ref, out32):
        within(t, j, 0.02)
        print("the tier against f32:", end=" ")
        within(t, t32, VCYCLE_CONTRACT_TOL)
        assert float(np.abs(t - t32).max()) > 0


# The two facts the marches' tier rests on (csrc/multisweep_march.cuh: a
# plane of a and rhs is folded once, in place, at its first pass, and u is
# rounded to bf16 once, where its copies land), held on the twin that the
# card holds every bf16 march form to bit for bit (chip_smoke.py, kernels
# phase), so that a change to the twin that breaks either fails here.
FOLD_CASES = [
    ("open_mixed_faces", (12, 10, 8), JAX_KINDS),
    ("open_cf", (9, 8, 6), ((C, C), (C, C), (C, C))),
    ("periodic", (8, 10, 6), ((P, P), (P, P), (P, P))),
    ("periodic_x_open_yz", (8, 6, 10), ((P, P), (D, C), (C, N))),
    ("open_x_periodic_yz", (10, 8, 6), ((C, D), (P, P), (P, P))),
]


def plane_fold(rv, av, q, nx, *, kinds, rho, alpha, beta, dx):
    """The fold of x plane q alone, as a march folds a plane at its first
    pass: from that plane's rhs and a ((ny, nz) each) and its index q of nx,
    which alone gives the x faces' rule; (P, {axis: (PA, PB)}, K, T) in
    the operations and order of fused_sweeps._fold_coefs (c0 summed x, y,
    z over the open axes; periodic axes without PA, PB)."""
    dt = av.dtype
    b_inv = beta * (1.0 / (dx * dx))
    diag = alpha * av + 6.0 * b_inv
    lam = 1.0 / diag
    P_ = lam * b_inv
    one, zero = torch.ones((), dtype=dt), torch.zeros((), dtype=dt)
    pab, c_sum = {}, None
    for axis in (0, 1, 2):
        if kinds[axis][0] == P:
            pab[axis] = (None, None)
            continue
        c0l, c1l = tfs._ghost_lin(kinds[axis][0], rho)
        c0h, c1h = tfs._ghost_lin(kinds[axis][1], rho)
        if axis == 0:
            is_lo = torch.full((1, 1), q == 0)
            is_hi = torch.full((1, 1), q == nx - 1)
        else:
            n_ax = av.shape[axis - 1]
            idx = torch.arange(n_ax).view((-1, 1) if axis == 1 else (1, -1))
            is_lo, is_hi = idx == 0, idx == n_ax - 1
        a_vp = torch.where(is_hi, zero, torch.where(is_lo, one + c1l, one))
        b_vm = torch.where(is_lo, zero, torch.where(is_hi, one + c1h, one))
        c_ax = (torch.where(is_lo, torch.full((), c0l, dtype=dt), zero)
                + torch.where(is_hi, torch.full((), c0h, dtype=dt), zero))
        pab[axis] = (P_ * a_vp, P_ * b_vm)
        c_sum = c_ax if c_sum is None else c_sum + c_ax
    k_uc = (1.0 - lam * (alpha * av)) + P_ * (
        (c_sum - 6.0) if c_sum is not None else -6.0)
    return P_, pab, k_uc, lam * rv


def test_fold_coefs_folds_each_x_plane_alone():
    """_fold_coefs (the twin's fold) folds every x plane from that plane
    alone: plane q of the whole level's fold is, bit for bit, the fold of
    plane q by itself with the x faces' rule from q, in f32 and as the
    tier's bf16 terms. So a march may fold a plane once, when it enters,
    whatever planes its segment holds."""
    kw = dict(rho=2.0, alpha=1.0, beta=-1.0, dx=0.37)
    for seed, (cid, shape, kinds) in enumerate(FOLD_CASES):
        _, rhs, a = fields(shape, 40 + seed)
        rv, av = torch.from_numpy(rhs), torch.from_numpy(a)
        P_, pab, k_uc, t_rhs = tfs._fold_coefs(rv, av, kinds=kinds, **kw)
        for q in range(shape[0]):
            Pq, pabq, kq, tq = plane_fold(rv[q], av[q], q, shape[0],
                                          kinds=kinds, **kw)
            terms = [(P_[q], Pq), (k_uc[q], kq), (t_rhs[q], tq)]
            for axis in (0, 1, 2):
                whole, alone = pab[axis], pabq[axis]
                assert (whole[0] is None) == (alone[0] is None), (cid, q)
                if whole[0] is not None:
                    for w, s in zip(whole, alone):
                        terms.append((w.expand(shape)[q], s.expand(
                            shape[1:])))
            for w, s in terms:
                assert torch.equal(w, s), (cid, q)
                assert torch.equal(w.to(torch.bfloat16),
                                   s.to(torch.bfloat16)), (cid, q)


@pytest.mark.parametrize("nsweeps", [1, 2, 4])
@pytest.mark.parametrize("cid,shape,kinds,lo", [
    ("open_mixed_faces", (12, 10, 8), JAX_KINDS, (0, 0, 0)),
    ("open_odd_lo", (10, 8, 6), ((C, C), (C, C), (C, C)), (3, 0, 0)),
    ("periodic", (8, 10, 6), ((P, P), (P, P), (P, P)), (0, 0, 0)),
    ("periodic_odd_lo", (8, 6, 10), ((P, P), (D, C), (C, N)), (1, 2, 2)),
])
def test_tier_twin_on_a_rounded_state_is_the_twin(cid, shape, kinds, lo,
                                                  nsweeps):
    """The tier's twin (gsrb_sweeps_folded, compute_dtype bfloat16, the
    kernels' colour select) rounds the state to bf16 where it starts: given
    the state rounded beforehand it returns the same bits. So a march may
    round each value of u once, where it enters its ring, and read it as
    bf16 without rounding again."""
    u, rhs, a = (torch.from_numpy(x) for x in fields(shape, 7))
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.37, lo=lo, compute_dtype=BF16, _where=True)
    rounded = u.to(torch.bfloat16).to(torch.float32)
    assert not torch.equal(rounded, u)
    raw = tfs.gsrb_sweeps_folded(u, rhs, a, **kw)
    assert raw.dtype == torch.float32
    assert torch.equal(tfs.gsrb_sweeps_folded(rounded, rhs, a, **kw), raw)
    # and rounding again changes nothing: the passes leave bf16 values
    assert torch.equal(raw.to(torch.bfloat16).to(torch.float32), raw)
