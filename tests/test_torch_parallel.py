"""The sharded solve of the port (mg_ic_code_tpu_torch/parallel) against the
JAX package's on the conftest's 8 virtual CPU devices: the same numpy
inputs, made from a seed, go through both. The port's mesh names the CPU
once per JAX device (convert.mesh_from_jax). Pallas kernels run in
interpret mode on the JAX side; on the port's side the halo kernels' plain
versions run (CPU tensors).

Tolerances: f64 sharded ops 1e-11 (relax) / 1e-12 (residual) relative, as
the JAX package's own tests/test_parallel.py holds its sharded ops against
its serial ones; the halo kernels' plain versions against the JAX kernels
1e-6 (f32) and 1e-13 (f64) of max|reference|; the composite solve and the
Picard iterations 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_ic_code_tpu.grid.boxes import Box as JBox
from mg_ic_code_tpu.grid.geometry import BCSpec as JBCSpec
from mg_ic_code_tpu.grid.geometry import single_level_geom as j_single
from mg_ic_code_tpu.ops import fused_sweeps as jfs
from mg_ic_code_tpu.parallel import distributed as jdist
from mg_ic_code_tpu.parallel import mesh as jmesh
from mg_ic_code_tpu.solver import multigrid as jmg

from mg_ic_code_tpu_torch import convert
from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import BCSpec, single_level_geom
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.parallel import distributed as tdist
from mg_ic_code_tpu_torch.parallel import halo as thalo
from mg_ic_code_tpu_torch.parallel import mesh as tmesh
from mg_ic_code_tpu_torch.parallel.shards import ShardSet
from mg_ic_code_tpu_torch.solver import multigrid as tmg

torch.set_num_threads(1)

D, N, P, C = "dirichlet", "neumann", "periodic", "cf"
BCS = {
    "dirichlet": dict(),
    "periodic": dict(periodic=True),
    "mixed": dict(bc_lo=(1, 0, 1), bc_hi=(0, 1, 0)),
}


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    """A CPU tensor holding a copy of the numpy array `x`."""
    return torch.from_numpy(np.array(x, copy=True))


def _mesh_pair(shape=None, ndev=8):
    """A JAX mesh over the first `ndev` virtual devices and the port's
    mesh of the same axes and shape on the CPU."""
    jm = jmesh.make_mesh(jax.devices()[:ndev], shape)
    return jm, convert.mesh_from_jax(jm, "cpu")


def _specs(n, bc, jm, tm, nsmooth=2, smoother="auto"):
    jg = j_single(n, 1.0, JBCSpec(**BCS[bc]))
    tg = single_level_geom(n, 1.0, BCSpec(**BCS[bc]))
    js = jmg.make_level_spec(jg, 0, alpha=1.0, beta=-1.0, nsmooth=nsmooth,
                             mesh=jm, smoother=smoother)
    ts = tmg.make_level_spec(tg, 0, alpha=1.0, beta=-1.0, nsmooth=nsmooth,
                             mesh=tm, smoother=smoother)
    return js, ts


def _close(out, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol)


# ----------------------------------------------------------------- policy


def test_policy_matches_jax():
    """level_spec, _shard_counts, choose_mesh_shape (never z) and host_mesh
    give the JAX package's decisions on the same extents and counts."""
    for mshape in [None, (4, 2), (2, 4), (2, 2, 2)]:
        jm, tm = _mesh_pair(mshape)
        assert tuple(tm.axis_names) == tuple(jm.axis_names)
        assert tm.shape == dict(jm.shape)
        for n in (8, 16, 32, 64):
            jg = j_single(n, 1.0, JBCSpec())
            tg = single_level_geom(n, 1.0, BCSpec())
            assert tmesh.level_spec(tg, 0, tm) == tuple(
                jmesh.level_spec(jg, 0, jm)), (mshape, n)
            js, ts = _specs(n, "dirichlet", jm, tm)
            for d in range(js.ndepths):
                assert tmg._shard_counts(ts, d) == jmg._shard_counts(js, d)
                assert tmg._shard_count(ts, d) == jmg._shard_count(js, d)
    grids = [(256, 256, 256), (64, 64, 64), (960, 144, 144),
             (128, 32, 1024), (48, 48, 48), (8, 8, 8), (96, 96, 96)]
    for ndev in range(1, 33):
        for g in grids:
            shape = tdist.choose_mesh_shape(g, ndev)
            assert shape == jdist.choose_mesh_shape(g, ndev), (g, ndev)
            assert len(shape) <= 2
    for n_cells in (None, (64, 64, 64), (32, 64, 64)):
        tm = tdist.host_mesh(n_cells, devices=["cpu"] * 8)
        jm = jdist.host_mesh(n_cells)
        assert tm.shape == dict(jm.shape) and tm.size == 8
    assert tmesh.patch_axis(tm, 4) == jmesh.patch_axis(jm, 4)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_mesh_needs_a_device_or_names_one():
    """make_mesh / host_mesh never fall to the CPU by themselves; a
    multi-process bootstrap that cannot start raises rather than run
    alone: NCCL (the default backend) without a CUDA device, and gloo
    when no other process answers within the timeout."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError):
            tdist.host_mesh((64, 64, 64))
    m = tmesh.make_mesh(["cpu"] * 4, (2, 2))
    assert m.home == torch.device("cpu") and m.shape == {"x": 2, "y": 2}
    assert m.device_at({"x": 1, "y": 1}) == torch.device("cpu")
    tdist.initialize()  # one process: a no-op
    assert tdist.process_count() == 1 and not tdist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
            tdist.initialize("localhost:1234", num_processes=2,
                             process_id=0)
    with pytest.raises(RuntimeError, match="could not start"):
        tdist.initialize(f"localhost:{_free_port()}", num_processes=2,
                         process_id=1, backend="gloo", timeout=1)
    assert not tdist.is_initialized()


def test_gather_and_placement_match_jax():
    """gather_global gives the JAX package's host value of the same level;
    is_coordinator agrees on one process; shard_level_list / shard_fields
    put a level the mesh does not cut whole on the mesh's home device and
    a level it cuts as its shards (the JAX package's placement), values
    unchanged."""
    x = _rng(3).standard_normal((16, 8, 4))
    jm, tm = _mesh_pair()
    jx = jmesh.shard_level_list([jnp.asarray(x)],
                                j_single(16, 1.0, JBCSpec()), jm)[0]
    np.testing.assert_array_equal(tdist.gather_global(_t(x)),
                                  jdist.gather_global(jx))
    assert tdist.gather_global(x) is x
    assert tdist.is_coordinator() == jdist.is_coordinator() is True
    placed = tmesh.shard_level_list([_t(x)], tm)
    fields = tmesh.shard_fields([{"a": _t(x), "d": {"b": _t(x)}}], tm)
    for t in (placed[0], fields[0]["a"], fields[0]["d"]["b"]):
        assert t.device == tm.home
        np.testing.assert_array_equal(t.numpy(), x)
    big = _rng(4).standard_normal((64, 8, 4))
    cut = tmesh.shard_level_list([_t(big)], tm)[0]
    cut_f = tmesh.shard_fields([{"d": {"b": _t(big)}}], tm)[0]["d"]["b"]
    for t in (cut, cut_f):
        assert isinstance(t, ShardSet) and t.counts == (8, 1, 1)
        np.testing.assert_array_equal(t.join().numpy(), big)
    # the one cut rule, per level and per depth
    assert tmesh.shard_counts(tm, (64, 8, 4)) == (8, 1, 1)
    for too_small in ((16, 8, 4), (56, 8, 4), (60, 8, 4)):
        assert tmesh.shard_counts(tm, too_small) == (1, 1, 1)
        assert tmesh.level_spec(single_level_geom(too_small, 1.0, BCSpec()),
                                0, tm) == (None, None, None)


def test_stream_global_slabs_tiles():
    """Tiles of at most max_bytes along the axis, permuted on request, that
    reassemble the array; a host array is one tile."""
    x = torch.arange(2 * 5 * 3 * 7, dtype=torch.float64).reshape(2, 5, 3, 7)
    plane = 2 * 5 * 3 * 8  # bytes of one z-plane of x
    tiles = list(tdist.stream_global_slabs(x, axis=3, max_bytes=2 * plane,
                                           perm=(0, 3, 2, 1)))
    assert [a for a, _ in tiles] == [0, 2, 4, 6]
    got = np.concatenate([b for _, b in tiles], axis=1)
    np.testing.assert_array_equal(got, x.permute(0, 3, 2, 1).numpy())
    arr = np.ones((3, 4))
    assert len(list(tdist.stream_global_slabs(arr))) == 1


# ------------------------------------------------------- plain sharded ops


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("bc", list(BCS))
def test_make_sharded_level_ops_matches_jax(bc, overlap):
    """The x-slab plain ops (both forms) against the JAX package's, f64."""
    from mg_ic_code_tpu.parallel import halo as jhalo

    n = 32
    jm, tm = _mesh_pair()
    js, ts = _specs(n, bc, jm, tm)
    rng = _rng(11)
    a = rng.uniform(0.5, 2.0, (n, n, n))
    rhs = rng.standard_normal((n, n, n))
    u0 = rng.standard_normal((n, n, n))
    jc = jmg.build_level_coefs(js, jnp.asarray(a))
    tc = tmg.build_level_coefs(ts, _t(a))
    j_relax, j_res = jhalo.make_sharded_level_ops(js, jm, 0, nsweeps=2,
                                                  overlap=overlap)
    t_relax, t_res = thalo.make_sharded_level_ops(ts, tm, 0, nsweeps=2,
                                                  overlap=overlap)
    sh = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec("x"))
    put = lambda x: jax.device_put(jnp.asarray(x), sh)  # noqa: E731
    ref = jax.jit(j_relax)(put(a), put(np.asarray(jc["lam"][0])), put(u0),
                           put(rhs))
    out = t_relax(tc["a"][0], tc["lam"][0], _t(u0), _t(rhs))
    _close(out, ref, 1e-11, 1e-11)
    ref_r = jax.jit(j_res)(put(a), put(np.asarray(ref)), put(rhs))
    out_r = t_res(tc["a"][0], _t(np.asarray(ref)), _t(rhs))
    _close(out_r, ref_r, 1e-12, 1e-12)


@pytest.mark.parametrize("mshape,with_b,bc", [
    ((4, 2), False, "dirichlet"), ((4, 2), False, "periodic"),
    ((4, 2), False, "mixed"), ((2, 2, 2), False, "dirichlet"),
    ((4, 2), True, "dirichlet"),
])
def test_make_sharded_level_ops_2d_matches_jax(mshape, with_b, bc):
    """Pencils, blocks and variable bCoef through mg.relax /
    mg.residual_homog on both sides, f64."""
    n = 32
    jm, tm = _mesh_pair(mshape)
    js, ts = _specs(n, bc, jm, tm)
    assert tmg._shard_counts(ts, 0) == jmg._shard_counts(js, 0) == (
        tuple(mshape) + (1,) * (3 - len(mshape)))
    rng = _rng(12)
    a = rng.uniform(0.5, 2.0, (n, n, n))
    b = rng.uniform(0.8, 1.2, (n, n, n)) if with_b else None
    rhs = rng.standard_normal((n, n, n))
    u0 = rng.standard_normal((n, n, n))
    jc = jmg.build_level_coefs(js, jnp.asarray(a),
                               None if b is None else jnp.asarray(b))
    tc = tmg.build_level_coefs(ts, _t(a), None if b is None else _t(b))
    sh = jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(*jmesh.level_spec(
            j_single(n, 1.0, JBCSpec(**BCS[bc])), 0, jm)))
    put = lambda x: jax.device_put(jnp.asarray(x), sh)  # noqa: E731
    jcs = {"a": (put(a),), "b": (None if b is None else put(b),),
           "lam": (put(np.asarray(jc["lam"][0])),)}
    ref = jmg.relax_jit(js, jcs, 0, put(u0), put(rhs), 3)
    out = tmg.relax(ts, tc, 0, _t(u0), _t(rhs), 3)
    _close(out, ref, 1e-11, 1e-11)
    same = np.asarray(ref)
    ref_r = jmg.residual_homog_jit(js, jcs, 0, put(same), put(rhs))
    out_r = tmg.residual_homog(ts, tc, 0, _t(same), _t(rhs))
    _close(out_r, ref_r, 1e-12, 1e-12)


# ------------------------------------------------- the two halo kernels


def _kinds(bc_name):
    g = j_single(16, 1.0, JBCSpec(**BCS[bc_name]))
    return jmg.face_kinds(g, 0)


def _pads(rng, u, H, npdt, meta, kinds):
    """Random neighbour rows in the (2H, ny, nz) pads; where an edge flag
    marks a domain face (x not periodic), the contract's fill instead: the
    face's one-ring ghost plane H deep in u's pad (the JAX kernel reads it
    at its first pass), zeros in rhs's and a's."""
    from mg_ic_code_tpu.ops.ghosts import ghost_plane

    shape = (2 * H,) + u.shape[1:]
    pads = [rng.standard_normal(shape).astype(npdt),
            rng.standard_normal(shape).astype(npdt),
            rng.uniform(0.5, 2.0, shape).astype(npdt)]
    if kinds[0][0] != P:
        if meta[0]:
            pads[0][:H] = np.asarray(ghost_plane(kinds[0][0], u[:1], u[1:2],
                                                 2.0))
            pads[1][:H] = pads[2][:H] = 0.0
        if meta[1]:
            pads[0][H:] = np.asarray(ghost_plane(kinds[0][1], u[-1:],
                                                 u[-2:-1], 2.0))
            pads[1][H:] = pads[2][H:] = 0.0
    return pads


# (label, meta, kinds): seam on both sides, domain face below / above,
# both faces, periodic x through the pads; odd x_off in most
HALO_CASES = [
    ("seams_odd_off", (0, 0, 7, 0), "dirichlet"),
    ("face_below", (1, 0, 0, 0), "mixed"),
    ("face_above", (0, 1, 23, 0), "mixed"),
    ("both_faces", (1, 1, 0, 0), "dirichlet"),
    ("periodic_x", (0, 0, 5, 0), "periodic"),
]


@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("case", HALO_CASES, ids=[c[0] for c in HALO_CASES])
def test_halo_plain_matches_jax_multisweep_halo(case, dt, nsweeps):
    """The plain version of multisweep_relax(halo=...) against the JAX
    kernel's halo form (interpret mode), the same pads and meta."""
    label, meta, bc = case
    npdt, tol = {"f32": (np.float32, 1e-6), "f64": (np.float64, 1e-13)}[dt]
    shape = (16, 8, 16)
    H = 2 * nsweeps
    rng = _rng(21)
    u = rng.standard_normal(shape).astype(npdt)
    rhs = rng.standard_normal(shape).astype(npdt)
    a = rng.uniform(0.5, 2.0, shape).astype(npdt)
    kinds = _kinds(bc)
    pads = _pads(rng, u, H, npdt, meta, kinds)
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.37, lo=(1, 0, 2))
    ref = jfs.multisweep_relax(
        jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a), bx=8,
        interpret=True, halo=tuple(jnp.asarray(p) for p in pads)
        + (jnp.asarray(meta, jnp.int32),), **kw)
    kernel_counts.reset()
    out = tfs.multisweep_relax(_t(u), _t(rhs), _t(a),
                               halo=tuple(_t(p) for p in pads) + (meta,),
                               **kw)
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_halo"] == 1
    ref = np.asarray(ref)
    assert np.abs(out.numpy() - ref).max() <= tol * np.abs(ref).max(), label


# (label, meta, y extent of the level, kinds): interior pencil, each face
# of x and y at the domain, periodic, odd offsets
PRE_CASES = [
    ("interior_odd_off", (0, 0, 9, 3), 24, "dirichlet"),
    ("x_face_low_y_face_low", (1, 0, 0, 0), 24, "mixed"),
    ("x_face_high_y_face_high", (0, 1, 17, 16), 24, "mixed"),
    ("whole_y", (1, 1, 0, 0), 8, "dirichlet"),
    ("periodic_odd_off", (0, 0, 3, 5), 16, "periodic"),
]


@pytest.mark.parametrize("nsweeps", [2, 4])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("case", PRE_CASES, ids=[c[0] for c in PRE_CASES])
def test_tiled_pre_plain_matches_jax(case, dt, nsweeps):
    """The plain version of multisweep_relax_tiled_pre against the JAX
    kernel (interpret mode) on the same prepadded operands and meta."""
    label, meta, ny_global, bc = case
    npdt, tol = {"f32": (np.float32, 1e-6), "f64": (np.float64, 1e-13)}[dt]
    nx, ny, nz = 8, 8, 128
    H = 2 * nsweeps
    rng = _rng(22)
    pre = (nx + 2 * H, ny + 2 * H, nz)
    u = rng.standard_normal(pre).astype(npdt)
    rhs = rng.standard_normal(pre).astype(npdt)
    a = rng.uniform(0.5, 2.0, pre).astype(npdt)
    kinds = _kinds(bc)
    # the contract at a domain x face: the face's ghost plane H deep
    if kinds[0][0] != P:
        from mg_ic_code_tpu.ops.ghosts import ghost_plane

        if meta[0]:
            u[:H] = np.asarray(ghost_plane(kinds[0][0], u[H:H + 1],
                                           u[H + 1:H + 2], 2.0))
        if meta[1]:
            u[H + nx:] = np.asarray(ghost_plane(
                kinds[0][1], u[H + nx - 1:H + nx], u[H + nx - 2:H + nx - 1],
                2.0))
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.37, lo=(0, 1, 0), ny_global=ny_global)
    ref = jfs.multisweep_relax_tiled_pre(
        jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a),
        jnp.asarray(meta, jnp.int32), bx=8, by=8, interpret=True, **kw)
    kernel_counts.reset()
    out = tfs.multisweep_relax_tiled_pre(_t(u), _t(rhs), _t(a), meta, **kw)
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_tiled_pre"] == 1
    ref = np.asarray(ref)
    assert out.shape == (nx, ny, nz)
    assert np.abs(out.numpy() - ref).max() <= tol * np.abs(ref).max(), label


# --------------------------------------------- the sharded relax, end on end


def _kernel_spec(jm, tm, shape, bc):
    jg = j_single(shape[0], 1.0, JBCSpec(**BCS[bc]))
    kinds = jmg.face_kinds(jg, 0)
    common = dict(kinds=kinds, dx=(1.0 / shape[0],), rho=(2.0,), alpha=1.0,
                  beta=-1.0, nsmooth=4, smoother="pallas")
    js = jmg.LevelMGSpec(boxes=(JBox.from_shape(shape),), mesh=jm, **common)
    ts = tmg.LevelMGSpec(boxes=(Box.from_shape(shape),), mesh=tm, **common)
    return js, ts


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_sharded_relax_matches_jax(bc):
    """halo.sharded_relax (8 x-slabs of a 64x8x128 level, the halo kernel's
    plain version per slab) against the JAX package's through mg.relax."""
    shape = (64, 8, 128)
    jm, tm = _mesh_pair()
    js, ts = _kernel_spec(jm, tm, shape, bc)
    assert tmg._shard_count(ts, 0) == jmg._shard_count(js, 0) == 8
    rng = _rng(31)
    a = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    rhs = rng.standard_normal(shape).astype(np.float32)
    u0 = rng.standard_normal(shape).astype(np.float32)
    jc = jmg.build_level_coefs(js, jnp.asarray(a))
    tc = tmg.build_level_coefs(ts, _t(a))
    sh = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec("x"))
    ref = np.asarray(jmg.relax_jit(js, jc, 0, jax.device_put(u0, sh),
                                   jax.device_put(rhs, sh), 4))
    kernel_counts.reset()
    out = tmg.relax(ts, tc, 0, _t(u0), _t(rhs), 4)
    # 2 chunks of 2 sweeps x 8 slabs
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_halo"] == 16
    assert np.abs(out.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_sharded_relax_2d_matches_jax(bc):
    """halo.sharded_relax_2d on a (4, 2) pencil mesh (prepadded halo kernel's
    plain version per pencil) against the JAX package's through mg.relax."""
    shape = (32, 32, 128)
    jm, tm = _mesh_pair((4, 2))
    js, ts = _kernel_spec(jm, tm, shape, bc)
    assert tmg._shard_counts(ts, 0) == jmg._shard_counts(js, 0) == (4, 2, 1)
    rng = _rng(32)
    a = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    rhs = rng.standard_normal(shape).astype(np.float32)
    u0 = rng.standard_normal(shape).astype(np.float32)
    jc = jmg.build_level_coefs(js, jnp.asarray(a))
    tc = tmg.build_level_coefs(ts, _t(a))
    sh = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec("x", "y"))
    ref = np.asarray(jmg.relax_jit(js, jc, 0, jax.device_put(u0, sh),
                                   jax.device_put(rhs, sh), 4))
    kernel_counts.reset()
    out = tmg.relax(ts, tc, 0, _t(u0), _t(rhs), 4)
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_tiled_pre"] == 16
    assert np.abs(out.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    # and against the port's unsharded plain sweeps of the whole level
    whole = tfs.gsrb_sweeps_folded(
        _t(u0), _t(rhs), _t(a), None, nsweeps=4, kinds=ts.kinds, rho=2.0,
        alpha=1.0, beta=-1.0, dx=1.0 / shape[0], lo=(0, 0, 0))
    assert torch.equal(out, whole)


# ------------------------------------------------------------- the slice


def test_composite_solve_with_mesh_matches_jax_and_unsharded():
    """solve_linear on a 32^3 level cut into 8 pencils ((4, 2) mesh, f64:
    the plain sharded ops at depth 0; the level placed as its shards and
    the solution handed back so) against the JAX package's sharded solve
    and against the port's solve without a mesh, 1e-10."""
    from mg_ic_code_tpu.config import SolverConfig as JCfg
    from mg_ic_code_tpu.solver import composite as jcomp
    from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
    from mg_ic_code_tpu_torch.solver import composite as tcomp

    n = 32
    kw = dict(alpha=1.0, beta=-1.0, max_level=0, n_cells=(n, n, n), L=1.0,
              num_mg_smooth=4, num_mg_iterations=1, max_iterations=20,
              tolerance=1e-10)
    jm, tm = _mesh_pair((4, 2))
    rng = _rng(41)
    a = rng.uniform(0.5, 2.0, (n, n, n))
    rhs = rng.standard_normal((n, n, n))
    jg = j_single(n, 1.0, JBCSpec())
    tg = single_level_geom(n, 1.0, BCSpec())
    js = jcomp.make_amr_spec(jg, JCfg(**kw), jm)
    assert jmg._shard_counts(js.level_specs[0], 0) == (4, 2, 1)
    put = lambda x: jmesh.shard_level_list([jnp.asarray(x)], jg, jm)  # noqa
    jc = jcomp.build_coefs_jit(js, put(a))
    ref = jcomp.solve_linear_jit(js, jc, put(rhs), put(np.zeros_like(rhs)))
    outs = {}
    for label, mesh in (("sharded", tm), ("unsharded", None)):
        ts = tcomp.make_amr_spec(tg, TCfg(**kw), "cpu", mesh)
        tc = tcomp.build_coefs(ts, tcomp.place(ts, [_t(a)]))
        out = tcomp.solve_linear(ts, tc, tcomp.place(ts, [_t(rhs)]))
        assert isinstance(out.x[0], ShardSet) == (mesh is not None)
        outs[label] = out._replace(x=[
            x.join() if isinstance(x, ShardSet) else x for x in out.x])
        assert bool(outs[label].converged)
    assert tmg._shard_counts(
        tcomp.make_amr_spec(tg, TCfg(**kw), "cpu", tm).level_specs[0], 0
    ) == (4, 2, 1)
    assert int(outs["sharded"].iters) == int(ref.iters)
    _close(outs["sharded"].x[0], ref.x[0], 1e-10, 1e-12)
    _close(outs["sharded"].x[0], outs["unsharded"].x[0], 1e-10, 1e-12)


def test_sharded_bbh_two_picard_iterations():
    """Two Picard iterations of the small two-level BBH
    (tests/test_nonlinear.py::small_bbh_cfg, max_level = 1) with a 2-shard
    x mesh (the 16^3 base and level 1 take the explicit-halo path) against
    the JAX package's sharded run and the port's unsharded run: f64,
    1e-10. Where the JAX package places its levels (the min_local of its
    shard_level_list, which test_sharded_bbh_end_to_end lowers) changes no
    value; the port holds every level the mesh cuts as its shards and
    joins the result at the end."""
    from mg_ic_code_tpu.config import SolverConfig as JCfg
    from mg_ic_code_tpu.solver import nonlinear as jnl
    from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
    from mg_ic_code_tpu_torch.solver import composite as tcomp
    from mg_ic_code_tpu_torch.solver import nonlinear as tnl
    from tests.test_torch_nonlinear import small_bbh_kw

    kw = small_bbh_kw(max_level=1, max_nl_iterations=2)
    jm, tm = _mesh_pair(ndev=2)
    jres = jnl.poisson_solve(JCfg(**kw), mesh=jm, verbose=False)
    sharded = tnl.poisson_solve(TCfg(**kw), device="cpu", mesh=tm,
                                verbose=False)
    plain = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    specs = tcomp.make_amr_spec(sharded.geom, TCfg(**kw), "cpu", tm)
    counts = [tmg._shard_counts(s, 0) for s in specs.level_specs]
    assert (2, 1, 1) in counts, counts
    # the history to 1e-10 of its first entry: the second entry is a
    # correction 4e-4 times the first, and the two packages' unsharded runs
    # already differ there by 3.7e-10 of itself (tests/test_torch_nonlinear;
    # 3.2e-10 read here against the JAX sharded run)
    for res in (jres, plain):
        np.testing.assert_allclose(
            sharded.dpsi_norm_history, res.dpsi_norm_history, rtol=0,
            atol=1e-10 * res.dpsi_norm_history[0])
        assert sharded.linear_iters == list(res.linear_iters)
        for p_s, p_r in zip(sharded.psi, res.psi):
            _close(p_s, p_r, 1e-10, 1e-12)


def test_cli_with_mesh(tmp_path, monkeypatch):
    """main.run with a mesh prints the sharding line and writes what the
    run without one writes (the final checkpoint's psi to 1e-10)."""
    import os

    import mg_ic_code_tpu_torch as mgt
    from mg_ic_code_tpu_torch import main
    from mg_ic_code_tpu_torch.io import chombo_hdf5

    if not chombo_hdf5.HAVE_H5PY:
        pytest.skip("needs h5py to write the files")
    canonical = os.path.join(os.path.dirname(mgt.__file__), "params",
                             "canonical.txt")
    over = ["N = 16 16 16", "L = 16.0", "max_level = 1",
            "refine_threshold = 0.1", "block_factor = 4", "buffer_size = 2",
            "max_grid_size = 16", "numMGIterations = 1",
            "max_NL_iterations = 2", "verbosity = 1", "bh1_bare_mass = 0.2",
            "bh2_bare_mass = 0.2", "bh1_offset = 2.0", "bh2_offset = -2.0",
            "precond_precision = double"]
    psi = {}
    for label, mesh in (("mesh", tmesh.make_mesh(["cpu"] * 2)),
                        ("none", None)):
        d = tmp_path / label
        d.mkdir()
        monkeypatch.chdir(d)
        from contextlib import redirect_stdout
        import io

        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main.run(["main", canonical] + over, device="cpu", mesh=mesh)
        assert rc == 0
        said = "sharding over 2 devices (host-major mesh, shape {'x': 2})"
        assert (said in buf.getvalue()) == (mesh is not None)
        _, _, _, named = chombo_hdf5.read_level_data(
            "vcPoissonFinal.3d.hdf5", 0)
        psi[label] = np.asarray(named["chi"])
    _close(psi["mesh"], psi["none"], 1e-10, 1e-12)


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_row12_flat_served_by_multisweep_relax(bc):
    """The JAX package's multisweep_relax_flat (single-device flat rung,
    lane-misaligned shapes, no halo) computes what the port's
    multisweep_relax computes: held against it (interpret mode) at
    16x8x48, bx = 8, nsweeps 4; f32 within 1e-6 of max|reference|."""
    shape = (16, 8, 48)
    kinds = _kinds(bc)
    rng = _rng(51)
    u = rng.standard_normal(shape).astype(np.float32)
    rhs = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    kw = dict(nsweeps=4, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.37,
              lo=(3, 0, 0))
    ref = np.asarray(jfs.multisweep_relax_flat(
        jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a), bx=8,
        interpret=True, **kw))
    out = tfs.multisweep_relax(_t(u), _t(rhs), _t(a), **kw).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
