"""generate_hierarchy of the PyTorch port against the JAX package: the two
must produce the same forest, box for box (the tag threshold compares f64
regrid conditions that agree to the last few ulps, far from any tag's
margin), plus the host-side copies (boxes, geometry, Berger-Rigoutsos)."""

import dataclasses

import numpy as np
import pytest
import torch

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid import br_native as jbr
from mg_ic_code_tpu.grid import tagging as jtag

from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.grid import br_native as tbr
from mg_ic_code_tpu_torch.grid import tagging as ttag

torch.set_num_threads(1)


def cfg_kw(**kw):
    base = dict(
        alpha=1.0, beta=-1.0, L=32.0, n_cells=(32, 32, 32), max_level=2,
        refine_threshold=0.3, block_factor=4, buffer_size=3,
        bh1_bare_mass=0.3, bh2_bare_mass=0.3, bh1_offset=6.0,
        bh2_offset=-6.0, bh1_momentum=0.03, bh2_momentum=-0.03,
        bh1_spin=0.03, bh2_spin=0.03, phi_amplitude=0.05, verbosity=0,
    )
    base.update(kw)
    return base


def plain(geom):
    return (
        [(b.lo, b.hi) for b in geom.boxes],
        [(b.lo, b.hi) for b in geom.domain_boxes],
        tuple(geom.parent), tuple(geom.dx), tuple(geom.domain_length),
    )


@pytest.mark.parametrize("max_level", [2, 3])
@pytest.mark.parametrize("decomp", ["bbox", "patches"])
def test_hierarchy_box_for_box(max_level, decomp):
    kw = cfg_kw(max_level=max_level, level_decomposition=decomp)
    jgeom = jtag.generate_hierarchy(JCfg(**kw))
    tgeom = ttag.generate_hierarchy(TCfg(**kw), device="cpu")
    assert jgeom.max_depth == max_level
    if decomp == "patches":
        assert jgeom.num_levels > max_level + 1  # a real forest
    assert plain(tgeom) == plain(jgeom)
    for l in range(jgeom.num_levels):
        for axis in range(3):
            for side in (0, 1):
                assert tgeom.face_is_cf(l, axis, side) == jgeom.face_is_cf(
                    l, axis, side)
        assert [b.shape for b in tgeom.mg_depth_boxes(l)] == [
            b.shape for b in jgeom.mg_depth_boxes(l)]
        np.testing.assert_array_equal(tgeom.coords1d(l, 0, 1),
                                      jgeom.coords1d(l, 0, 1))


def test_regrid_condition_and_decomposition():
    kw = cfg_kw(max_level=1)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jgeom = jtag.generate_hierarchy(jcfg)
    tgeom = ttag.generate_hierarchy(tcfg, device="cpu")
    jc = jtag._regrid_condition_np(jgeom, jcfg, 1)
    tc = ttag._regrid_condition_np(tgeom, tcfg, 1, "cpu")
    # f64, same formulas: last-ulp pow/log differences only
    np.testing.assert_allclose(tc, jc, rtol=1e-12, atol=0)
    jd = jtag.tag_box_decomposition(jcfg, jgeom, n_shards=4)
    td = ttag.tag_box_decomposition(tcfg, tgeom, n_shards=4, device="cpu")
    assert [(r["entry"], [(b.lo, b.hi) for b in r["boxes"]], r["shard"])
            for r in td] == [
        (r["entry"], [(b.lo, b.hi) for b in r["boxes"]], r["shard"])
        for r in jd]
    assert ttag.memory_report(tcfg, tgeom, device="cpu") == \
        jtag.memory_report(jcfg, jgeom)


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_tags_copies_agree(seed):
    rng = np.random.default_rng(seed)
    tags = rng.random((16, 12, 8)) > 0.9
    tags[2:6, 3:7, 1:5] = True
    args = dict(fill_ratio=0.6, max_box_size=8, block_factor=2,
                lo_offset=(4, 0, 2))
    jb = jbr.cluster_tags(tags, **args)
    tb = tbr.cluster_tags(tags, **args)
    assert [(b.lo, b.hi) for b in tb] == [(b.lo, b.hi) for b in jb]
    # the pure-Python clustering and load balance were copied verbatim
    jp = jbr._cluster_py(tags.astype(np.uint8), 0.6, 8, 2)
    tp = tbr._cluster_py(tags.astype(np.uint8), 0.6, 8, 2)
    assert [(b.lo, b.hi) for b in tp] == [(b.lo, b.hi) for b in jp]
    assert tbr._load_balance_py(tp, 3) == jbr._load_balance_py(jp, 3)


def test_config_copy_matches(tmp_path):
    from mg_ic_code_tpu.config import load_params as jload
    from mg_ic_code_tpu_torch.config import load_params as tload
    import mg_ic_code_tpu_torch as mgt
    import os

    canonical = os.path.join(os.path.dirname(mgt.__file__), "params",
                             "canonical.txt")
    for ov in ([], ["max_level = 3", "precond_precision = single"]):
        assert dataclasses.asdict(tload(canonical, ov)) == \
            dataclasses.asdict(jload(canonical, ov))
    cfg = tload(canonical)
    assert cfg.n_cells == (64, 64, 64) and cfg.L == 100.0
    assert cfg.max_level == 6 and cfg.num_mg_smooth == 4
    assert cfg.num_mg_iterations == 2
    assert cfg.coefficient_average_type == "harmonic"
    with pytest.raises(ValueError):
        tload(canonical, ["smoother = bogus"])
