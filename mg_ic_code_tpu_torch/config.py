"""Configuration: `key = value` parameter files plus the solver config struct.

Mirrors the reference's Chombo ParmParse usage (reference:
PoissonParameters.cpp:26-131, Main_PoissonSolver.cpp:107-126, SetBCs.cpp:53-58)
with the same key names, so the reference's `params.txt` can be read verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

ARITHMETIC = "arithmetic"
HARMONIC = "harmonic"

# bc_lo/bc_hi flag values (reference: SetBCs.cpp:69-123, params.txt:47-54)
BC_DIRICHLET = 0
BC_NEUMANN = 1
BC_PERIODIC = 2


class ParamFile:
    """`key = value` config parser with CLI-style overrides.

    Equivalent of Chombo's ParmParse (reference: Main_PoissonSolver.cpp:272
    builds ParmParse from the file plus trailing argv overrides). Values are
    whitespace-separated tokens after ``=``; ``#`` starts a comment. `get_*`
    raise KeyError for missing keys; `query_*` return a default instead.
    """

    def __init__(self, path: str | None = None, overrides: Sequence[str] = ()):
        self._table: dict[str, list[str]] = {}
        if path is not None:
            with open(path) as f:
                for line in f:
                    self._parse_line(line)
        for ov in overrides:  # later entries win, like ParmParse CLI args
            self._parse_line(ov)

    def _parse_line(self, line: str) -> None:
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            return
        key, _, rest = line.partition("=")
        self._table[key.strip()] = rest.split()

    def contains(self, key: str) -> bool:
        return key in self._table

    def _tokens(self, key: str) -> list[str]:
        if key not in self._table:
            raise KeyError(f"parameter '{key}' not found")
        toks = self._table[key]
        if not toks:
            raise ValueError(f"parameter '{key}' has no value")
        return toks

    # -- required getters ---------------------------------------------------
    def get_real(self, key: str) -> float:
        return float(self._tokens(key)[0])

    def get_int(self, key: str) -> int:
        return int(self._tokens(key)[0])

    def get_str(self, key: str) -> str:
        return self._tokens(key)[0]

    def get_real_arr(self, key: str, n: int) -> tuple[float, ...]:
        toks = self._tokens(key)
        if len(toks) < n:
            raise ValueError(f"parameter '{key}' needs {n} values, got {len(toks)}")
        return tuple(float(t) for t in toks[:n])

    def get_int_arr(self, key: str, n: int) -> tuple[int, ...]:
        toks = self._tokens(key)
        if len(toks) < n:
            raise ValueError(f"parameter '{key}' needs {n} values, got {len(toks)}")
        return tuple(int(t) for t in toks[:n])

    # -- optional getters ---------------------------------------------------
    def query_real(self, key: str, default: float) -> float:
        return self.get_real(key) if self.contains(key) else default

    def query_int(self, key: str, default: int) -> int:
        return self.get_int(key) if self.contains(key) else default

    def query_str(self, key: str, default: str) -> str:
        return self.get_str(key) if self.contains(key) else default


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """All run parameters (frozen, hashable).

    Field names follow the reference's PoissonParameters struct
    (PoissonParameters.H:29-63) and the extra solver knobs read directly by
    the reference's main program (Main_PoissonSolver.cpp:107-126).
    """

    # operator: [alpha*aCoef*I - beta*bCoef*Laplacian] dpsi = rhs
    alpha: float = 1.0
    beta: float = -1.0

    # physics
    G_Newton: float = 1.0
    phi_amplitude: float = 0.1
    phi_wavelength: float = 1.0
    bh1_bare_mass: float = 0.5
    bh2_bare_mass: float = 0.5
    bh1_spin: float = 0.1  # J_z
    bh2_spin: float = 0.1
    bh1_momentum: float = 0.05  # P_y
    bh2_momentum: float = -0.05
    bh1_offset: float = 10.0  # x offset from centre
    bh2_offset: float = -10.0

    # grid (refRatio is enforced = 2 on every level and cells cubic,
    # reference: PoissonParameters.cpp:75-85)
    max_level: int = 0
    n_cells: tuple[int, int, int] = (64, 64, 64)
    L: float = 100.0
    refine_threshold: float = 0.1
    block_factor: int = 8
    max_grid_size: int = 16
    fill_ratio: float = 0.5
    buffer_size: int = 3

    # multigrid / Krylov
    num_mg_smooth: int = 4  # numMGsmooth
    num_mg: int = 1  # numMG: 1 = V-cycle, 2 = W-cycle
    num_mg_iterations: int = 1  # numMGIterations (V-cycles per precond)
    pre_cond_solver_depth: int = -1  # preCondSolverDepth
    max_iterations: int = 10  # BiCGStab iteration cap
    max_nl_iterations: int = 4  # outer Picard loop cap
    tolerance: float = 1.0e-7
    hang: float = 1.0e-8
    verbosity: int = 3
    coefficient_average_type: str = ARITHMETIC

    # accelerator execution options (framework extensions; absent keys
    # default to reference-equivalent behaviour)
    # "single" = f32 MG preconditioner (the mixed-precision mode: V-cycles
    # and their BOTTOM BiCGStab run in f32, whose bottom tolerance silently
    # floors at 1e-6 — what f32 can resolve; see multigrid.bottom_solve).
    # The OUTER BiCGStab stays f64, so outer convergence to
    # tolerance=1e-10 is unaffected apart from a possible extra outer
    # iteration. "auto" resolves when the solver spec is built
    # (precision.precond_dtype): single on a CUDA device, double on the
    # CPU.
    precond_precision: str = "auto"
    smoother: str = "auto"  # "auto" | "xla" | "pallas"
    # colour-pass arithmetic of the smoother kernels: "single" keeps the
    # sweep arithmetic at the operand (f32) precision; "bfloat16" parses
    # (the key set is the reference's) but composite.make_amr_spec refuses
    # it: this package's kernels sweep at operand precision. "auto" = single.
    smoother_precision: str = "auto"
    # coarsest-depth solve: "auto" = dense direct inverse when the bottom
    # box is small and the operator non-singular, else BiCGStab;
    # "direct"/"bicgstab" force one (multigrid._use_direct_bottom)
    bottom_solver: str = "auto"
    # scalar-field profile: "gaussian" (MyPhiFunction.H:14-15, Dirichlet
    # mode) or "sine" (the commented-out periodic variant, :17-20)
    phi_profile: str = "gaussian"
    # average fine psi down onto covered coarse cells after each Picard
    # update (framework extension; the reference never syncs covered cells,
    # which leaves the outer loop a covered-cell feedback floor)
    average_down: bool = False
    # refined-level representation: "bbox" = one dense bounding box per
    # depth (chain hierarchy); "patches" = a forest of dense patches, one
    # per well-separated Berger-Rigoutsos tag cluster (the analogue of
    # Chombo's disjoint box layouts, SetGrids.cpp:108-126 — cuts the
    # dense-bbox waste ~2.2x on the canonical BBH config, see
    # tagging.memory_report)
    level_decomposition: str = "bbox"
    # cap on sibling patches per depth in "patches" mode (closest pairs
    # merge into their bounding box above the cap)
    max_patches: int = 4
    # batched execution of same-shape sibling patches in the AMR V-cycle
    # (the LoadBalance task-parallelism role, SetGrids.cpp:57,126):
    # "auto" batches groups that cannot be slab-sharded on the device mesh
    # (otherwise every device would compute every patch, replicated);
    # "force" batches every same-shape group; "off" keeps the sequential
    # per-entry sweep
    forest_batching: str = "auto"

    # warm-start: path of a previously written vcPoissonFinal-format
    # checkpoint; the main program rebuilds the recorded hierarchy and seeds
    # psi from it (io.restart.load_state) instead of tagging grids and
    # starting from psi = 1. "" = cold start. Closes the read-in loop the
    # reference only mentions (SetGrids.cpp:29-30: "there is an option to
    # read in grids" — never implemented there).
    read_from_checkpoint: str = ""

    # boundary conditions
    is_periodic: bool = False
    bc_lo: tuple[int, int, int] = (0, 0, 0)
    bc_hi: tuple[int, int, int] = (0, 0, 0)
    bc_value: float = 0.0

    # --- derived -----------------------------------------------------------
    @property
    def num_levels(self) -> int:
        return self.max_level + 1

    @property
    def coarsest_dx(self) -> float:
        # dx = L / N_x, cubic cells enforced (PoissonParameters.cpp:82)
        return self.L / self.n_cells[0]

    @property
    def domain_length(self) -> tuple[float, float, float]:
        dx = self.coarsest_dx
        return tuple(dx * n for n in self.n_cells)

    @property
    def ref_ratio(self) -> int:
        return 2


def load_params(path: str, overrides: Sequence[str] = ()) -> SolverConfig:
    """Read a reference-format params file into a SolverConfig.

    Key set and required-vs-optional status match getPoissonParameters
    (PoissonParameters.cpp:26-131) plus the main program's direct queries
    (Main_PoissonSolver.cpp:107-126).
    """
    pp = ParamFile(path, overrides)

    avg = pp.query_str("coefficient_average_type", ARITHMETIC)
    if avg not in (ARITHMETIC, HARMONIC):
        raise ValueError(f"bad coefficient_average_type in input: {avg}")

    # every enum-valued key fails loudly on a typo (a silent fall-back to
    # the default would e.g. lose the mixed-precision speedup or solve the
    # wrong scalar-field physics with no warning)
    for key, default, allowed in (
        ("precond_precision", "auto", ("auto", "double", "single")),
        ("smoother", "auto", ("auto", "xla", "pallas")),
        ("smoother_precision", "auto", ("auto", "single", "bfloat16")),
        ("bottom_solver", "auto", ("auto", "direct", "bicgstab")),
        ("phi_profile", "gaussian", ("gaussian", "sine")),
        ("level_decomposition", "bbox", ("bbox", "patches")),
        ("forest_batching", "auto", ("auto", "off", "force")),
    ):
        val = pp.query_str(key, default)
        if val not in allowed:
            raise ValueError(f"bad {key} in input: {val!r} (allowed: "
                             f"{', '.join(allowed)})")

    n_cells = pp.get_int_arr("N", 3)

    return SolverConfig(
        alpha=pp.get_real("alpha"),
        beta=pp.get_real("beta"),
        G_Newton=pp.get_real("G_Newton"),
        phi_amplitude=pp.get_real("phi_amplitude"),
        phi_wavelength=pp.get_real("phi_wavelength"),
        bh1_bare_mass=pp.get_real("bh1_bare_mass"),
        bh2_bare_mass=pp.get_real("bh2_bare_mass"),
        bh1_spin=pp.get_real("bh1_spin"),
        bh2_spin=pp.get_real("bh2_spin"),
        bh1_offset=pp.get_real("bh1_offset"),
        bh2_offset=pp.get_real("bh2_offset"),
        bh1_momentum=pp.get_real("bh1_momentum"),
        bh2_momentum=pp.get_real("bh2_momentum"),
        verbosity=pp.query_int("verbosity", 3),
        max_level=pp.get_int("max_level"),
        n_cells=n_cells,
        L=pp.get_real("L"),
        refine_threshold=pp.get_real("refine_threshold"),
        block_factor=pp.get_int("block_factor"),
        max_grid_size=pp.get_int("max_grid_size"),
        fill_ratio=pp.get_real("fill_ratio"),
        buffer_size=pp.get_int("buffer_size"),
        coefficient_average_type=avg,
        is_periodic=bool(pp.get_int("is_periodic")),
        bc_lo=pp.get_int_arr("bc_lo", 3),
        bc_hi=pp.get_int_arr("bc_hi", 3),
        bc_value=pp.query_real("bc_value", 0.0),
        num_mg_smooth=pp.query_int("numMGsmooth", 4),
        num_mg=pp.query_int("num_mg", 1),
        num_mg_iterations=pp.query_int("numMGIterations", 1),
        pre_cond_solver_depth=pp.query_int("preCondSolverDepth", -1),
        max_iterations=pp.query_int("max_iterations", 10),
        max_nl_iterations=pp.query_int("max_NL_iterations", 4),
        tolerance=pp.query_real("tolerance", 1.0e-7),
        hang=pp.query_real("hang", 1.0e-8),
        precond_precision=pp.query_str("precond_precision", "auto"),
        smoother=pp.query_str("smoother", "auto"),
        smoother_precision=pp.query_str("smoother_precision", "auto"),
        bottom_solver=pp.query_str("bottom_solver", "auto"),
        phi_profile=pp.query_str("phi_profile", "gaussian"),
        average_down=bool(pp.query_int("average_down", 0)),
        level_decomposition=pp.query_str("level_decomposition", "bbox"),
        max_patches=pp.query_int("max_patches", 4),
        forest_batching=pp.query_str("forest_batching", "auto"),
        read_from_checkpoint=pp.query_str("read_from_checkpoint", ""),
    )
