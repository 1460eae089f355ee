"""Command line: `python -m mg_ic_code_tpu_torch.main <params_file> [key=value ...]`.

Mirrors the reference binary's contract (Main_PoissonSolver.cpp:259-293):
argv[1] is a ParmParse-format parameter file, later arguments override keys.
Reads params, builds the tagged AMR hierarchy, runs the nonlinear solve, and
writes the per-iteration plotfiles plus the GRChombo-restart checkpoint.
Exit status 0 on success, 2 on non-convergence (the reference propagates the
solver exit status and MayDays on ||dpsi|| > 0.1).

The run is on the CUDA device. Without one, `run` prints the error and
returns 2: nothing carries on on the CPU by itself (tests pass
`device="cpu"`; no params key and no environment variable selects the
device). The files need `h5py`; where it is missing `run` says so and
returns 2 BEFORE the solve, not at the first snapshot.

With more than one card visible the level arrays are sharded over all of
them (parallel/distributed.host_mesh, topology from the base grid), as the
JAX package's command line does; `mesh` names a mesh instead (one card may
appear in it several times). Every level the mesh cuts then stays on its
cards for the whole solve (parallel/mesh.py): only pads, ghost planes,
level windows and the depth chain's reshards cross between them, and the
plotfiles stream their tiles from the shards. One process driving all the
cards launches every shard's work itself, so that run is still slower
than one card on the configurations measured (PERF.md); make one card
visible (CUDA_VISIBLE_DEVICES) to run unsharded.

Over several processes, one per card, as torchrun starts them:

    torchrun --nproc-per-node=4 -m mg_ic_code_tpu_torch.main params.txt

the module's entry (and `cli()`) first brings up torch.distributed
(parallel/distributed.initialize: NCCL, the environment torchrun sets;
the role of scripts/run_tpu_pod.sh for the JAX package), the mesh spans
every process's card, each process writes its log to `pout.<n>` (process
0 also to stdout), the coordinator alone writes the files, and every
process returns the same exit code.
"""

from __future__ import annotations

import sys

import torch


def run(argv: list[str], device=None, mesh=None) -> int:
    """The command line's run (see the module docstring): 0, or 2 where
    the solve did not converge or cannot run; over several processes the
    largest of the processes' codes, on every one."""
    from mg_ic_code_tpu_torch.parallel import distributed as dist

    return dist.agree_max(_run(argv, device, mesh))


def _run(argv: list[str], device=None, mesh=None) -> int:
    if len(argv) < 2:
        print(f" usage {argv[0]} <input_file_name> ", file=sys.stderr)
        return 0

    from mg_ic_code_tpu_torch import precision
    from mg_ic_code_tpu_torch.config import load_params
    from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu_torch.io import chombo_hdf5 as io
    from mg_ic_code_tpu_torch.io.logging import pout, set_verbosity
    from mg_ic_code_tpu_torch.solver.nonlinear import (
        NonConvergenceError, poisson_solve, prepare_iteration,
    )

    try:
        device = precision.resolve_device(device)
        io._require_h5py()
    except RuntimeError as e:
        print(f" {e}", file=sys.stderr)
        return 2

    cfg = load_params(argv[1], overrides=argv[2:])
    set_verbosity(cfg.verbosity)
    pout(f"alpha, beta = {cfg.alpha}, {cfg.beta}")
    pout(f"periodicity = {int(cfg.is_periodic)}")

    initial_psi = None
    if cfg.read_from_checkpoint:
        # warm start: rebuild the recorded hierarchy and seed psi from the
        # checkpoint instead of tagging grids from scratch (the read-in
        # loop SetGrids.cpp:29-30 mentions but the reference never built)
        from mg_ic_code_tpu_torch.io import restart

        geom, initial_psi, _ = restart.load_state(
            cfg.read_from_checkpoint, cfg, device=device
        )
        pout(f"warm start from {cfg.read_from_checkpoint} "
             f"({geom.num_levels} levels)")
    else:
        geom = generate_hierarchy(cfg, device=device)
    pout(
        "grids: "
        + ", ".join(
            f"level {d}: "
            + " + ".join(
                str(geom.boxes[e].shape) for e in geom.entries_at_depth(d)
            )
            + f" @ dx={geom.dx[geom.entries_at_depth(d)[0]]:.6g}"
            for d in range(geom.max_depth + 1)
        )
    )

    def snapshot(nl_iter, state):
        # per-iteration plotfile, like output_solver_data
        _, rhs_list, _ = prepare_iteration(
            geom, cfg, state["fields"], state["psi"]
        )
        io.write_solver_data(
            f"vcPoissonOut.3d_{nl_iter}.hdf5", geom, cfg,
            state["dpsi"], rhs_list, state["psi"], state["fields"], nl_iter,
        )

    mesh = choose_mesh(cfg, device, mesh)

    try:
        res = poisson_solve(cfg, geom=geom, device=device,
                            output_hook=snapshot, initial_psi=initial_psi,
                            mesh=mesh)
    except NonConvergenceError as e:
        print(str(e), file=sys.stderr)
        return 2

    io.write_final_data(
        "vcPoissonFinal.3d.hdf5", geom, cfg, res.psi, res.fields,
        res.constant_K,
    )
    pout("wrote vcPoissonFinal.3d.hdf5")
    return 0


def choose_mesh(cfg, device, mesh=None):
    """The mesh of a run: `mesh` as given, else one over every process's
    card where several processes run, or over every visible card where one
    process sees several (the MPI rank decomposition's role; x slabs or
    (x, y) pencils by the base grid, parallel/distributed.host_mesh), else
    None. Says so when there is one."""
    from mg_ic_code_tpu_torch.io.logging import pout
    from mg_ic_code_tpu_torch.parallel import distributed as dist

    if mesh is None and dist.process_count() > 1:
        mesh = dist.host_mesh(cfg.n_cells, None if device.type == "cuda"
                              else [device])
    elif mesh is None and device.type == "cuda" and (
            torch.cuda.device_count() > 1):
        mesh = dist.host_mesh(cfg.n_cells)
    if mesh is not None:
        pout(f"sharding over {mesh.size} devices "
             f"(host-major mesh, shape {mesh.shape})")
    return mesh


def main(argv: list[str], device=None, backend=None) -> int:
    """The process's whole run: torch.distributed brought up where
    torchrun (or the environment it sets) asks for several processes
    (NCCL unless `backend` names another), `run` on `device` (None: the
    card), and torch.distributed left again."""
    from mg_ic_code_tpu_torch.parallel import distributed as dist

    dist.initialize(backend=backend)
    try:
        return run(argv, device)
    finally:
        dist.finalize()


def cli() -> None:
    """console_scripts entry point."""
    sys.exit(main(sys.argv))


if __name__ == "__main__":
    sys.exit(main(sys.argv))
