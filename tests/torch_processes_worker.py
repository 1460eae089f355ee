"""Subprocess worker for tests/test_torch_processes.py.

One process of the port's run over torch.distributed (gloo on the CPU,
two CPU mesh positions per process: with two processes a mesh of four),
started by torchrun, whose environment (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) it reads as the command line's entry does; or, started
alone (`solo`), one process driving the same positions: the reference
every multi-process result is held to bit for bit.

Usage: torchrun --standalone --nproc-per-node=2 \
           torch_processes_worker.py <outdir>
       python torch_processes_worker.py <outdir>          # solo

Each process works in <outdir>/p<process> and writes there, last,
`result.json` (a file: the processes' standard outputs share one pipe,
where two long lines can interleave) with, per run: the Picard history, Krylov counts, K,
a digest of every level of the result, the counters of
ops/kernel_counts (HALO, the kernels' plain calls), a digest of the
transport's plans and the bytes of its copies by (source, destination),
and the files it wrote. Runs, in order:

  io         the writers on a 32^3 base with two sibling patches (every
             level cut into four x-slabs), a small tile bound so that
             every level streams in many tiles (the port of the JAX
             package's test_two_process_bootstrap_and_io)
  canonical  main.run on the canonical parameters at 16^3, max_level 2,
             3 Picard iterations, f64 preconditioner, on the (2, 2)
             pencils main.choose_mesh's host_mesh gives four positions
  periodic_x, periodic_pencil
             poisson_solve of the periodic box at 32^3 on 4 x-slabs and on
             (2, 2) pencils, f32 preconditioner through the kernels'
             paths (smoother = pallas: their plain versions on the CPU)
  periodic_ycut
             the periodic box at 8 x 32 x 32 on the (2, 2) pencils: every
             cut depth is cut along y alone, at positions 0 and 1, so that
             over two processes the second holds no shard of any of them
  forest     composite.solve_linear on the JAX package's test forest (a
             16^3 base, two sibling 8x12x12 patches) on a (2, 1, 2) mesh of
             the four positions, f32 preconditioner on the kernels' paths:
             the pair is a batch group computed on the x axis, at
             positions 0 and 2, which over two processes are each
             process's own
  entry      the command line's entry, main.main, on the canonical
             parameters, last (it leaves torch.distributed): over the
             processes the mesh is the one main.choose_mesh builds, one CPU
             position a process; alone, main.run over the same two
             positions named
"""

import faulthandler
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(ROOT, "mg_ic_code_tpu_torch", "params")
CANONICAL = ["max_level = 2", "N = 16 16 16", "max_NL_iterations = 3",
             "precond_precision = double", "verbosity = 3"]
PERIODIC = ["N = 32 32 32", "max_NL_iterations = 3",
            "precond_precision = single", "smoother = pallas",
            "verbosity = 0"]
YCUT = ["N = 8 32 32"]
# a process that waits on another for longer than the whole run takes
# prints where it waits and exits (the test then fails, not hangs)
WATCHDOG_S = 75


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


class Plans:
    """What the transport carries out: a running digest of every plan (its
    transfers' sources and destinations in order: their shapes and dtypes
    are the receiver's own shards', which a process at neither end does
    not know), and the bytes of its copies by (source, destination),
    counted on the process that owns the destination (a whole level,
    WHOLE: process 0), so that the processes' tallies add up to one
    process's."""

    def __init__(self, transport):
        self.h = hashlib.sha256()
        self.n = 0
        self.traffic: dict = {}
        orig = transport.exchange

        def exchange(mesh, plan, moved=True):
            for t in plan:
                self.h.update(repr((t.src, t.dst)).encode())
                if mesh is None or t.src == t.dst:
                    continue
                owner = (0 if t.dst == transport.WHOLE
                         else mesh.owner(t.dst))
                if owner == mesh.rank:
                    key = (t.src, t.dst)
                    self.traffic[key] = self.traffic.get(key, 0) + (
                        transport.nbytes(t.shape, t.dtype))
            self.n += 1
            return orig(mesh, plan, moved)

        transport.exchange = exchange

    def take(self) -> dict:
        out = {"plans": self.n, "digest": self.h.hexdigest()[:16],
               "traffic": sorted([s, d, n] for (s, d), n in
                                 self.traffic.items())}
        self.h, self.n, self.traffic = hashlib.sha256(), 0, {}
        return out


def counters() -> dict:
    from mg_ic_code_tpu_torch.ops import kernel_counts

    snap = kernel_counts.snapshot()
    return {"halo": snap["halo"], "plain_calls": snap["plain_calls"],
            "launches": snap["launches"]}


def solve_record(res) -> dict:
    return {"history": res.dpsi_norm_history,
            "linear_iters": res.linear_iters,
            "constant_K": res.constant_K,
            "psi": [digest(p) for p in res.psi],
            "dpsi": [digest(p) for p in res.dpsi]}


def io_run(mesh, rank: int) -> dict:
    """The writers over the mesh (values per entry as the JAX package's
    worker chooses them)."""
    import torch

    from mg_ic_code_tpu_torch.config import SolverConfig
    from mg_ic_code_tpu_torch.grid.boxes import Box
    from mg_ic_code_tpu_torch.grid.geometry import BCSpec, HierarchyGeom
    from mg_ic_code_tpu_torch.io import chombo_hdf5 as io
    from mg_ic_code_tpu_torch.io.logging import pout
    from mg_ic_code_tpu_torch.parallel import distributed as dist
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh
    from mg_ic_code_tpu_torch.parallel.shards import ShardSet
    from mg_ic_code_tpu_torch.physics import level_data as ld

    pout(f"process {rank}/{dist.process_count()} up: {mesh.size} "
         f"positions, owners {list(mesh.owners)}")
    cfg = SolverConfig(max_level=1, n_cells=(32, 32, 32), L=64.0,
                       bh1_offset=8.0, bh2_offset=-8.0)
    dom0 = Box.from_shape((32, 32, 32))
    pa = Box((8, 8, 8), (39, 23, 23))
    pb = Box((8, 40, 40), (39, 55, 55))
    geom = HierarchyGeom(
        boxes=(dom0, pa, pb),
        domain_boxes=(dom0, dom0.refine(2), dom0.refine(2)),
        dx=(2.0, 1.0, 1.0), domain_length=(64.0, 64.0, 64.0), bc=BCSpec(),
        parent=(-1, 0, 0))

    def level(v):
        return pmesh.shard_level_list(
            [torch.full(geom.shape(e), v(e), dtype=torch.float64)
             for e in range(3)], mesh, geom)

    psi = level(lambda e: 1.0 + 0.01 * e)
    dpsi = level(lambda e: 0.5 + e)
    rhs = level(lambda e: 2.0 + e)
    fields = pmesh.shard_fields(
        [ld.problem_fields(geom, cfg, e, device="cpu") for e in range(3)],
        mesh, geom)
    assert all(isinstance(p, ShardSet) and p.counts == (4, 1, 1)
               for p in psi), [getattr(p, "counts", None) for p in psi]
    held = [sorted(p.shards) for p in psi]
    tiles = []
    orig = dist.stream_global_slabs

    def recording(x, axis=0, max_bytes=1 << 25, perm=None):
        for a, blk in orig(x, axis, max_bytes, perm):
            tiles.append(None if blk is None else blk.nbytes)
            yield a, blk

    io._STREAM_MAX_BYTES = 4096
    dist.stream_global_slabs = recording
    os.makedirs("io", exist_ok=True)
    try:
        io.write_solver_data("io/vcPoissonOut.3d_0.hdf5", geom, cfg, dpsi,
                             rhs, psi, fields, 0)
        io.write_final_data("io/vcPoissonFinal.3d.hdf5", geom, cfg, psi,
                            fields, constant_K=-0.25)
    finally:
        dist.stream_global_slabs = orig
        io._STREAM_MAX_BYTES = 1 << 25
    got = [t for t in tiles if t is not None]
    pout(f"process {rank}: writes done ({len(tiles)} tiles, "
         f"{len(got)} assembled here)")
    return {"held": held, "tiles": len(tiles), "assembled": len(got),
            "max_tile_bytes": max(got, default=0),
            "io_files": sorted(os.listdir("io"))}


def cli_run(call) -> dict:
    """`call()`, main.run or main.main on the canonical parameters, with
    the solve's result kept."""
    from mg_ic_code_tpu_torch.solver import nonlinear

    kept = {}
    orig = nonlinear.poisson_solve

    def keep(*a, **kw):
        kept["res"] = orig(*a, **kw)
        return kept["res"]

    nonlinear.poisson_solve = keep
    try:
        rc = call()
    finally:
        nonlinear.poisson_solve = orig
    return {"rc": rc, **solve_record(kept["res"])}


def canonical_argv() -> list:
    return ["main", os.path.join(PARAMS, "canonical.txt"), *CANONICAL]


def periodic_run(mesh, extra=()) -> dict:
    import mg_ic_code_tpu_torch as mgt
    from mg_ic_code_tpu_torch.solver.nonlinear import poisson_solve

    cfg = mgt.load_params(os.path.join(PARAMS, "periodic.txt"),
                          PERIODIC + list(extra))
    return solve_record(poisson_solve(cfg, device="cpu", mesh=mesh,
                                      verbose=False))


def forest_run(mesh) -> dict:
    """composite.solve_linear on the forest (aCoef and rhs from a numpy
    seed, zero start) on `mesh` reshaped to (2, 1, 2)."""
    import numpy as np
    import torch

    from mg_ic_code_tpu_torch.config import SolverConfig
    from mg_ic_code_tpu_torch.grid.boxes import Box
    from mg_ic_code_tpu_torch.grid.geometry import BCSpec, HierarchyGeom
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh
    from mg_ic_code_tpu_torch.parallel.shards import ShardSet
    from mg_ic_code_tpu_torch.solver import composite as comp

    fmesh = pmesh.make_mesh(mesh.devices, (2, 1, 2), mesh.owners, mesh.rank)
    dom0 = Box.from_shape((16, 16, 16))
    geom = HierarchyGeom(
        boxes=(dom0, Box((4, 10, 10), (11, 21, 21)),
               Box((20, 10, 10), (27, 21, 21))),
        domain_boxes=(dom0, dom0.refine(2), dom0.refine(2)),
        dx=(1 / 16, 1 / 32, 1 / 32), domain_length=(1.0,) * 3, bc=BCSpec(),
        parent=(-1, 0, 0))
    cfg = SolverConfig(alpha=1.0, beta=-1.0, max_level=1,
                       n_cells=(16, 16, 16), num_mg_smooth=4,
                       num_mg_iterations=2, max_iterations=60,
                       tolerance=1e-11, precond_precision="single",
                       smoother="pallas")
    spec = comp.make_amr_spec(geom, cfg, "cpu", fmesh)
    rng = np.random.default_rng(17)
    a = [torch.tensor(rng.uniform(0.5, 2.0, geom.shape(l)))
         for l in range(3)]
    rhs = [torch.tensor(rng.standard_normal(geom.shape(l)))
           for l in range(3)]
    coefs = comp.build_coefs(spec, comp.place(spec, a))
    out = comp.solve_linear(spec, coefs, comp.place(spec, rhs))
    x = [v.join() if isinstance(v, ShardSet) else v for v in out.x]
    return {"batch_groups": [list(g) for g in spec.batch_groups],
            "positions": list(comp.batch_positions(spec, (1, 2))),
            "owners": list(fmesh.owners), "linear_iters": int(out.iters),
            "x": [digest(v) for v in x]}


def main() -> None:
    outdir = sys.argv[1]
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from mg_ic_code_tpu_torch import main as main_mod
    from mg_ic_code_tpu_torch.io import logging as tlog
    from mg_ic_code_tpu_torch.ops import kernel_counts
    from mg_ic_code_tpu_torch.parallel import distributed as dist
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh
    from mg_ic_code_tpu_torch.parallel import transport

    # torchrun's environment, as main's entry reads it (alone: a no-op)
    dist.initialize(backend="gloo", timeout=60)
    dist.initialize(backend="gloo")  # idempotent
    rank, nprocs = dist.process_index(), dist.process_count()
    here = os.path.join(outdir, f"p{rank}")
    os.makedirs(here, exist_ok=True)
    os.chdir(here)
    tlog.set_verbosity(2)
    per = 4 // nprocs
    plans = Plans(transport)
    out = {"rank": rank, "nprocs": nprocs}

    def record(name, fn, *args):
        kernel_counts.reset()
        plans.take()
        rec = fn(*args)
        out[name] = {**rec, **counters(), **plans.take()}

    mesh = dist.host_mesh(devices=["cpu"] * per)
    out["mesh"] = {"shape": mesh.shape, "owners": list(mesh.owners),
                   "devices": [str(d) for d in mesh.devices],
                   "home_position": mesh.home_position}
    record("io", io_run, mesh, rank)
    # the mesh main.run's choose_mesh gives four positions of a 16^3 base
    cmesh = dist.host_mesh((16, 16, 16), devices=["cpu"] * per)
    record("canonical", cli_run, lambda: main_mod.run(
        canonical_argv(), device="cpu", mesh=cmesh))
    record("periodic_x", periodic_run, dist.host_mesh(
        (32, 32, 32), devices=["cpu"] * per))
    pencils = pmesh.make_mesh(mesh.devices, (2, 2), mesh.owners, mesh.rank)
    record("periodic_pencil", periodic_run, pencils)
    record("periodic_ycut", periodic_run, pencils, YCUT)
    record("forest", forest_run, mesh)
    os.makedirs("entry")
    os.chdir("entry")
    if nprocs > 1:
        record("entry", cli_run, lambda: main_mod.main(
            canonical_argv(), device="cpu", backend="gloo"))
    else:
        emesh = dist.host_mesh((16, 16, 16), devices=["cpu"] * 2)
        record("entry", cli_run, lambda: main_mod.run(
            canonical_argv(), device="cpu", mesh=emesh))
    os.chdir("..")
    tlog.close()
    out["files"] = sorted(os.listdir("."))
    out["entry_files"] = sorted(os.listdir("entry"))
    with open(os.path.join(here, "result.json"), "w") as f:
        json.dump(out, f)
    dist.finalize()


if __name__ == "__main__":
    main()
