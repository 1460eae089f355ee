"""The port's smoother dispatch as decision tables, and the V-cycle whose
top depth is too big for the coarse tower.

`plan_for(spec, shape, dtype, device_type, n)` is `relax_kernel_plan` in
terms of what it looks at, so the tables can be read without a card:
which rung each level of the periodic box and of the canonical hierarchy
takes, and where `tower_supported` lets the coarse tower start. One size
term rules both: the four arrays of a level against the card's 50 MB L2
cache (`fused_sweeps.L2_BYTES`).

The V-cycle test lowers that term so that a 32^3 level counts as big on the
CPU: its top depth then goes through the staged recursion (relax, restrict,
prolong in plain PyTorch) and the tower starts one depth below, which is
the path a 256^3 level takes on the card. It is held against the JAX
package's mg_vcycle (fused tower from depth 0, Pallas interpret mode).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.grid.geometry import BCSpec as JBC
from mg_ic_code_tpu.grid.geometry import single_level_geom as jgeom1
from mg_ic_code_tpu.solver import multigrid as jmg

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC
from mg_ic_code_tpu_torch.grid.geometry import single_level_geom as tgeom1
from mg_ic_code_tpu_torch.ops import coarse_tower as tct
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import multigrid as tmg

torch.set_num_threads(1)

D, NM, CF, PER = "dirichlet", "neumann", "cf", "periodic"
ALL_P = ((PER, PER),) * 3
ALL_D = ((D, D),) * 3
ALL_C = ((CF, CF),) * 3
PER_X = ((PER, PER), (D, NM), (CF, D))
PER_YZ = ((CF, D), (PER, PER), (PER, PER))
F32, F64 = torch.float32, torch.float64


def level_spec(kinds, smoother="auto"):
    return tmg.LevelMGSpec(
        kinds=kinds, boxes=(Box.from_shape((8, 8, 8)),), dx=(1.0,),
        rho=(2.0,), alpha=1.0, beta=-1.0, nsmooth=4, smoother=smoother)


def chain_spec(n, kinds):
    """The depth chain make_level_spec builds for an n^3 base level."""
    return tmg.make_level_spec(
        tgeom1(n, 1.0, TBC(periodic=kinds == ALL_P)), 0, alpha=1.0,
        beta=-1.0, nsmooth=4)


MS, WV = [("multisweep", 2)] * 2, [("wave", 2)] * 2
RES = [("resident", 4)]
# (shape, kinds, plan of 4 sweeps of an f32 level on the card)
PLAN_TABLE = [
    ((256, 256, 256), ALL_P, MS),     # the periodic box: 268 MB
    ((512, 512, 512), ALL_P, MS),
    ((256, 256, 256), PER_X, MS),     # periodic x beside ghost-rule faces
    ((512, 96, 96), PER_X, MS),       # 75 MB
    ((128, 128, 128), ALL_P, RES),    # 33 MB: stays in the L2
    ((272, 80, 80), PER_X, RES),      # 28 MB
    ((64, 64, 64), ALL_P, RES),
    ((255, 256, 256), ALL_P, RES),    # odd periodic extent
    ((256, 256, 255), PER_X, MS),     # odd, but not on a periodic axis
    ((256, 256, 256), ALL_D, WV),     # x open: the wavefront keeps it
    ((256, 256, 256), PER_YZ, WV),
    ((960, 144, 144), ALL_C, WV),
    ((512, 96, 96), ALL_C, WV),
    ((272, 80, 80), ALL_C, RES),
    ((64, 64, 64), ALL_D, RES),
]


@pytest.mark.parametrize(
    "shape,kinds,plan", PLAN_TABLE,
    ids=["x".join(map(str, s)) + "-" + k[0][0] + "-" + k[1][0]
         for s, k, _ in PLAN_TABLE])
def test_plan_table(shape, kinds, plan):
    spec = level_spec(kinds)
    assert tmg.plan_for(spec, shape, F32, "cuda", 4) == plan
    assert tmg.plan_for(spec, shape, F32, "cuda", 2) == (
        [("resident", 2)] if plan == RES else plan[:1])
    assert tmg.plan_for(spec, shape, F32, "cuda", 0) == []
    # never a one-launch rung: an odd count, variable bCoef, a CPU tensor
    assert tmg.plan_for(spec, shape, F32, "cuda", 3) == [("resident", 3)]
    assert tmg.plan_for(spec, shape, F32, "cuda", 4, const_b=False) == RES
    assert tmg.plan_for(level_spec(kinds, "pallas"), shape, F32, "cpu",
                        4) == RES
    # never a kernel: f64 operands, a CPU tensor under `auto`, the staged
    # smoother
    assert tmg.plan_for(spec, shape, F64, "cuda", 4) == [("xla", 4)]
    assert tmg.plan_for(spec, shape, F32, "cpu", 4) == [("xla", 4)]
    assert tmg.plan_for(level_spec(kinds, "xla"), shape, F32, "cuda",
                        4) == [("xla", 4)]


def test_plan_names_no_tpu_rung():
    """The JAX package's rungs "tiled", "pipelined", "flatp" fold into
    "multisweep"; "slab", "flat" and "legacy" have no counterpart."""
    seen = set()
    for shape, kinds, _ in PLAN_TABLE:
        for dev in ("cuda", "cpu"):
            for dt in (F32, F64):
                for n in (1, 2, 3, 4, 8):
                    plan = tmg.plan_for(level_spec(kinds), shape, dt, dev, n)
                    assert sum(s for _, s in plan) == n
                    seen |= {k for k, _ in plan}
    assert seen == {"wave", "multisweep", "resident", "xla"}


# (base n, kinds, itemsize, first depth the tower takes)
TOWER_TABLE = [
    (256, ALL_P, 4, 1),    # the periodic box: 256^3 staged, tower from 128^3
    (256, ALL_D, 4, 1),
    (512, ALL_P, 4, 2),
    (128, ALL_P, 4, 0),    # 33 MB
    (64, ALL_D, 4, 0),     # the canonical base level
    (128, ALL_P, 8, 1),    # f64 doubles the bytes
]


@pytest.mark.parametrize("n,kinds,itemsize,first", TOWER_TABLE)
def test_tower_start_table(n, kinds, itemsize, first):
    spec = chain_spec(n, kinds)
    coefs = {"b": (None,) * spec.ndepths}
    took = [tct.tower_supported(spec, coefs, d, itemsize)
            for d in range(spec.ndepths)]
    # not above `first`, then every depth with two or more depths below it
    assert took == [first <= d <= spec.ndepths - 3
                    for d in range(spec.ndepths)]
    assert spec.boxes[-1].shape == (4, 4, 4)


def test_canonical_amr_levels_never_reach_the_tower():
    """Levels above the base carry no depth chain (one box), so the size
    term changes nothing for them: the canonical counts per iteration stay
    as they were."""
    for shape in [(96, 80, 80), (960, 144, 144)]:
        spec = tmg.LevelMGSpec(
            kinds=ALL_C, boxes=(Box.from_shape(shape),), dx=(1.0,),
            rho=(2.0,), alpha=1.0, beta=-1.0, nsmooth=4)
        assert not tct.tower_supported(spec, {"b": (None,)}, 0)


@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
def test_vcycle_with_a_staged_top_depth_matches_jax(bc, monkeypatch):
    n = 32
    rng = np.random.default_rng(11)
    a = rng.uniform(0.5, 2.0, (n, n, n)).astype(np.float32)
    rhs = rng.standard_normal((n, n, n)).astype(np.float32)
    u0 = rng.standard_normal((n, n, n)).astype(np.float32)
    per = bc == "periodic"
    jspec = jmg.make_level_spec(
        jgeom1(n, 1.0, JBC(periodic=per)), 0, alpha=1.0, beta=-1.0,
        nsmooth=4, smoother="pallas")
    tspec = tmg.make_level_spec(
        tgeom1(n, 1.0, TBC(periodic=per)), 0, alpha=1.0, beta=-1.0,
        nsmooth=4, smoother="pallas")
    jco = jmg.build_level_coefs(jspec, jnp.asarray(a))
    plain = {k: [None if x is None else np.asarray(x) for x in jco[k]]
             for k in ("a", "b", "lam")}
    plain["binv"] = np.asarray(jco["binv"])
    (tco,) = cv.coefs_from_numpy((plain,), "cpu")
    ref = jmg.mg_vcycle_jit(jspec, jco, jnp.asarray(u0), jnp.asarray(rhs))

    # 4 * 32^3 * 4 B = 512 KiB counts as too big, 4 * 16^3 * 4 B = 64 KiB fits
    monkeypatch.setattr(tfs, "L2_BYTES", 256 << 10)
    assert not tct.tower_supported(tspec, tco, 0)
    assert tct.tower_supported(tspec, tco, 1)
    kernel_counts.reset()
    out = tmg.mg_vcycle(tspec, tco, torch.from_numpy(u0),
                        torch.from_numpy(rhs))
    plain_calls = kernel_counts.PLAIN_CALLS
    # pre and post smooth of the top depth through `relax` (a CPU tensor:
    # the resident rung's plain version), the tower once below it
    assert plain_calls["gsrb_relax"] >= 2
    assert plain_calls["tower_down"] == plain_calls["tower_up"] == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-5)
