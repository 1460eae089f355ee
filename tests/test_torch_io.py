"""The port's Chombo-HDF5 writers and readers against the JAX package's.

One small JAX solve (2 and 3 levels) is exported as plain numpy data and
carried into the port with convert.solve_state_from_plain; both packages
then write the plotfile and the GRChombo checkpoint from the same state.
Every attribute and the `boxes` dataset must be equal exactly,
`data:datatype=0` to 1e-12 relative (the 29-variable stack is recomputed
on each side: chi = psi0^-4 and A_ij * chi^1.5), and each package reads the
other's file."""

import dataclasses

import numpy as np
import pytest
import torch

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.io import chombo_hdf5 as jio
from mg_ic_code_tpu.solver import nonlinear as jnl

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.io import chombo_hdf5 as tio
from mg_ic_code_tpu_torch.physics import level_data as tld

h5py = pytest.importorskip("h5py")
torch.set_num_threads(1)


# One small JAX solve exported as plain numpy data (what convert takes);
# tests/test_torch_restart.py uses it too.

def small_kw(max_level: int) -> dict:
    """16^3 base, L = 16, weak punctures; refine_threshold low enough that
    max_level = 2 gives three levels."""
    return dict(
        alpha=1.0, beta=-1.0, L=16.0, n_cells=(16, 16, 16),
        max_level=max_level, refine_threshold=0.1, block_factor=4,
        buffer_size=2, num_mg_smooth=4, num_mg_iterations=1,
        max_iterations=20, max_nl_iterations=2, tolerance=1e-10,
        coefficient_average_type="harmonic", G_Newton=1.0,
        phi_amplitude=0.05, phi_wavelength=1.0,
        bh1_bare_mass=0.2, bh2_bare_mass=0.2, bh1_offset=2.0,
        bh2_offset=-2.0, bh1_momentum=0.02, bh2_momentum=-0.02,
        bh1_spin=0.02, bh2_spin=0.02, verbosity=0,
    )


def plain_geom(g) -> dict:
    pair = lambda b: (tuple(b.lo), tuple(b.hi))
    return dict(
        boxes=[pair(b) for b in g.boxes], parent=g.parent, dx=g.dx,
        bc=dataclasses.asdict(g.bc),
        domain_boxes=[pair(b) for b in g.domain_boxes],
        domain_length=g.domain_length, ref_ratio=g.ref_ratio,
    )


def plain_fields(fields) -> list:
    return [{k: ({c: np.asarray(x) for c, x in v.items()}
                 if isinstance(v, dict) else np.asarray(v))
             for k, v in f.items()} for f in fields]


def jax_solve_state(max_level: int):
    """(jax cfg, torch cfg, jax result, jax rhs list, plain state)."""
    kw = small_kw(max_level)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    res = jnl.poisson_solve(jcfg, verbose=False)
    _, rhs, _ = jnl.prepare_iteration(res.geom, jcfg, res.fields, res.psi)
    plain = dict(
        geom=plain_geom(res.geom),
        psi=[np.asarray(x) for x in res.psi],
        dpsi=[np.asarray(x) for x in res.dpsi],
        rhs=[np.asarray(x) for x in rhs],
        fields=plain_fields(res.fields), constant_K=res.constant_K,
    )
    return jcfg, tcfg, res, rhs, plain


@pytest.fixture(scope="module", params=[1, 2], ids=["2_levels", "3_levels"])
def state(request):
    jcfg, tcfg, res, rhs, plain = jax_solve_state(request.param)
    assert res.geom.num_levels == request.param + 1
    port = cv.solve_state_from_plain(plain, "cpu")
    return jcfg, tcfg, res, rhs, port


def _attrs_equal(a, b, where):
    assert sorted(a.attrs) == sorted(b.attrs), where
    for k in a.attrs:
        va, vb = a.attrs[k], b.attrs[k]
        assert a.attrs.get_id(k).dtype == b.attrs.get_id(k).dtype, (where, k)
        assert np.array_equal(np.asarray(va), np.asarray(vb)), (where, k)


def assert_files_equal(path_j, path_t):
    with h5py.File(path_j, "r") as fj, h5py.File(path_t, "r") as ft:
        names_j, names_t = [], []
        fj.visit(names_j.append)
        ft.visit(names_t.append)
        assert names_j == names_t
        _attrs_equal(fj, ft, "/")
        for name in names_j:
            _attrs_equal(fj[name], ft[name], name)
            if not isinstance(fj[name], h5py.Dataset):
                continue
            dj, dt = fj[name][...], ft[name][...]
            assert dj.dtype == dt.dtype and dj.shape == dt.shape, name
            if name.endswith("boxes"):
                assert np.array_equal(dj, dt), name
            else:
                np.testing.assert_allclose(dt, dj, rtol=1e-12, atol=0,
                                           err_msg=name)


@pytest.mark.parametrize("tile_bytes", [1 << 25, 1 << 12],
                         ids=["one_tile", "many_tiles"])
def test_final_data_equal(state, tmp_path, monkeypatch, tile_bytes):
    jcfg, tcfg, res, _, port = state
    monkeypatch.setattr(tio, "_STREAM_MAX_BYTES", tile_bytes)
    pj, pt = str(tmp_path / "j.hdf5"), str(tmp_path / "t.hdf5")
    jio.write_final_data(pj, res.geom, jcfg, res.psi, res.fields,
                         res.constant_K)
    tio.write_final_data(pt, port["geom"], tcfg, port["psi"],
                         port["fields"], port["constant_K"])
    assert_files_equal(pj, pt)


@pytest.mark.parametrize("tile_bytes", [1 << 25, 1 << 12],
                         ids=["one_tile", "many_tiles"])
def test_solver_data_equal(state, tmp_path, monkeypatch, tile_bytes):
    jcfg, tcfg, res, rhs, port = state
    monkeypatch.setattr(tio, "_STREAM_MAX_BYTES", tile_bytes)
    pj, pt = str(tmp_path / "j.hdf5"), str(tmp_path / "t.hdf5")
    jio.write_solver_data(pj, res.geom, jcfg, res.dpsi, rhs, res.psi,
                          res.fields, 3)
    tio.write_solver_data(pt, port["geom"], tcfg, port["dpsi"], port["rhs"],
                          port["psi"], port["fields"], 3)
    assert_files_equal(pj, pt)


def test_each_reads_the_others_file(state, tmp_path):
    jcfg, tcfg, res, _, port = state
    pj, pt = str(tmp_path / "j.hdf5"), str(tmp_path / "t.hdf5")
    jio.write_final_data(pj, res.geom, jcfg, res.psi, res.fields,
                         res.constant_K)
    tio.write_final_data(pt, port["geom"], tcfg, port["psi"],
                         port["fields"], port["constant_K"])
    for d in range(res.geom.num_levels):
        tb, tdom, tdx, tn = tio.read_level_data(pj, d)   # port reads JAX's
        jb, jdom, jdx, jn = jio.read_level_data(pt, d)   # JAX reads port's
        assert (tb.lo, tb.hi) == (jb.lo, jb.hi)
        assert (tdom.lo, tdom.hi) == (jdom.lo, jdom.hi) and tdx == jdx
        assert list(tn) == list(jn)
        for k in tn:
            np.testing.assert_allclose(tn[k], jn[k], rtol=1e-12, atol=0)
        boxes, _, _, patches = tio.read_level_patches(pj, d)
        assert len(boxes) == len(patches) == 1


def _last_level_stack(state):
    _, tcfg, _, _, port = state
    e = port["geom"].num_levels - 1
    return tld.grchombo_output_stack(port["psi"][e], port["fields"][e],
                                     tcfg, port["constant_K"])


def test_streaming_without_a_file(state, monkeypatch):
    """`_stream_fab_into(None, ...)` does every device operation and copy
    and writes nothing; the pieces it goes through tile each component's
    range exactly and their sums are the components' sums."""
    monkeypatch.setattr(tio, "_STREAM_MAX_BYTES", 1 << 12)
    stack = _last_level_stack(state)
    ncomp, cells = stack.shape[0], stack[0].numel()
    base = 7 * cells
    assert tio._stream_fab_into(None, base, cells, stack) is None
    pieces = [(off, flat.size, float(flat.sum()))
              for off, flat in tio._fab_pieces(base, cells, stack)]
    nxy = stack.shape[1] * stack.shape[2]
    assert len(pieces) > ncomp  # several tiles
    for c in range(ncomp):
        mine = sorted(p for p in pieces
                      if base + c * cells <= p[0] < base + (c + 1) * cells)
        pos = base + c * cells
        for off, size, _ in mine:
            assert off == pos and size % nxy == 0
            # a tile holds all components of its z-planes
            assert size * ncomp * 8 <= max(1 << 12, ncomp * nxy * 8)
            pos += size
        assert pos == base + (c + 1) * cells
        assert sum(p[2] for p in mine) == pytest.approx(
            float(stack[c].sum()), rel=1e-12, abs=1e-12)


def test_streamed_record_is_the_flattened_fab(state, monkeypatch):
    """Streamed in several tiles into a flat array, a box's record is what
    `_flatten_fab` makes of its components at once, and nothing around it
    is touched."""
    monkeypatch.setattr(tio, "_STREAM_MAX_BYTES", 1 << 12)
    stack = _last_level_stack(state)
    ncomp, cells = stack.shape[0], stack[0].numel()
    base = 5
    dset = np.full(base + ncomp * cells + 3, np.nan)
    tio._stream_fab_into(dset, base, cells, stack)
    np.testing.assert_array_equal(
        dset[base:base + ncomp * cells],
        tio._flatten_fab([c.numpy() for c in stack]))
    assert np.isnan(dset[:base]).all() and np.isnan(dset[-3:]).all()


def test_flatten_roundtrip_and_box_dtype():
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal((3, 4, 5)) for _ in range(2)]
    flat = tio._flatten_fab(arrs)
    np.testing.assert_array_equal(flat, jio._flatten_fab(arrs))
    back = tio._unflatten_fab(flat, (3, 4, 5), 2)
    for a, b in zip(arrs, back):
        np.testing.assert_array_equal(a, b)
    assert tio.BOX_DTYPE == jio.BOX_DTYPE
    assert tio.HAVE_H5PY
    tio._require_h5py()


def test_require_h5py_message(monkeypatch):
    monkeypatch.setattr(tio, "HAVE_H5PY", False)
    with pytest.raises(RuntimeError) as port_err:
        tio._require_h5py()
    monkeypatch.setattr(jio, "HAVE_H5PY", False)
    with pytest.raises(RuntimeError) as jax_err:
        jio._require_h5py()
    assert str(port_err.value) == str(jax_err.value)
