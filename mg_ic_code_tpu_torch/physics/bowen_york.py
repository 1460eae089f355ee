"""Bowen-York binary-black-hole data, vectorised over the whole grid.

Physics matches the reference's per-cell routines (SetBinaryBH.H:15-99):
the conformally-flat, maximal-slicing Bowen-York extrinsic curvature for two
punctures with linear momenta P and spins J (Alcubierre eq. 3.4.22),

  A_ij = 3/(2 r^2) [ n_i P_j + n_j P_i - (delta_ij - n_i n_j) (P.n) ]
       + 3/r^3 [ (J x n)_i n_j + (J x n)_j n_i ]

(the spin term in cross-product form; in the code it appears as
-3/r^3 [ eps_ilk n^l J^k n_j + ... ] = -3/r^3 (n x J)_i n_j + ..., the
same thing — sign locked by the independent epsilon-tensor oracle test)

summed over the two punctures, plus the singular Brill-Lindquist conformal
factor psi_bh = m1/(2?) ... = m1/r1 + m2/r2 (the reference keeps the bare
m/r convention, SetBinaryBH.H:85-99; the singular part is never stored in
the solved field, only added analytically — SetLevelData.cpp:50-54,118-119).

Everything is an element-wise tensor expression over the dense level arrays
instead of a quadruple-nested point loop.
"""

from __future__ import annotations

import torch

from mg_ic_code_tpu_torch.config import SolverConfig

# the six stored components, upper-triangle order (matches
# MULTIGRID_VARIABLE_NAMES A11_0..A33_0 declaration order A11,A12,A13,A22,A23,A33)
SYM_COMPS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _puncture_geometry(x, y, z, offset):
    """Distance and unit normal from a puncture offset along x
    (SetBinaryBH.H get_bh_radius)."""
    dx_, dy_, dz_ = x - offset, y, z
    r = torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
    n = (dx_ / r, dy_ / r, dz_ / r)
    return r, n


def _single_bh_aij(i, j, r, n, P, J):
    """One puncture's contribution to A_ij at every grid point."""
    delta = 1.0 if i == j else 0.0
    p_dot_n = sum(P[k] * n[k] for k in range(3) if P[k] != 0.0)
    term_p = (1.5 / (r * r)) * (
        n[i] * P[j] + n[j] * P[i] + (n[i] * n[j] - delta) * p_dot_n
    )
    # spin term: -3/r^3 * (eps_{ilk} n_j + eps_{jlk} n_i) n_l J_k, summed l,k
    # For J = (0,0,Jz): eps_{il3} n_l Jz -> i=0: eps_{013}=0? use full eps.
    eps = {
        (0, 1, 2): 1.0, (1, 2, 0): 1.0, (2, 0, 1): 1.0,
        (0, 2, 1): -1.0, (2, 1, 0): -1.0, (1, 0, 2): -1.0,
    }
    term_s = 0.0
    for k in range(3):
        if J[k] == 0.0:
            continue
        for l in range(3):
            e_ilk = eps.get((i, l, k), 0.0)
            e_jlk = eps.get((j, l, k), 0.0)
            if e_ilk == 0.0 and e_jlk == 0.0:
                continue
            term_s = term_s - (3.0 / (r * r * r)) * (
                (e_ilk * n[j] + e_jlk * n[i]) * n[l] * J[k]
            )
    return term_p + term_s


def binary_bh_aij(x, y, z, cfg: SolverConfig) -> dict[tuple[int, int], torch.Tensor]:
    """All six symmetric components of bar A_ij for the two punctures
    (SetBinaryBH.H:55-83). x, y, z are broadcastable centred coordinates."""
    r1, n1 = _puncture_geometry(x, y, z, cfg.bh1_offset)
    r2, n2 = _puncture_geometry(x, y, z, cfg.bh2_offset)
    P1 = (0.0, cfg.bh1_momentum, 0.0)
    P2 = (0.0, cfg.bh2_momentum, 0.0)
    J1 = (0.0, 0.0, cfg.bh1_spin)
    J2 = (0.0, 0.0, cfg.bh2_spin)
    out = {}
    for (i, j) in SYM_COMPS:
        out[(i, j)] = _single_bh_aij(i, j, r1, n1, P1, J1) + _single_bh_aij(
            i, j, r2, n2, P2, J2
        )
    return out


def aij_squared(aij: dict[tuple[int, int], torch.Tensor]) -> torch.Tensor:
    """bar A_ij bar A^ij with the flat conformal metric: diagonal once,
    off-diagonals twice (SetLevelData.cpp:110-116)."""
    a2 = 0.0
    for (i, j), comp in aij.items():
        w = 1.0 if i == j else 2.0
        a2 = a2 + w * comp * comp
    return a2


def psi_bh(x, y, z, cfg: SolverConfig) -> torch.Tensor:
    """Singular Brill-Lindquist part m1/r1 + m2/r2 (SetBinaryBH.H:85-99)."""
    r1, _ = _puncture_geometry(x, y, z, cfg.bh1_offset)
    r2, _ = _puncture_geometry(x, y, z, cfg.bh2_offset)
    return cfg.bh1_bare_mass / r1 + cfg.bh2_bare_mass / r2
