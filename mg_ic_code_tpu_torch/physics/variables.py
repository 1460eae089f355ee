"""Variable name tables for the two state layouts.

Mirrors the reference's enums so outputs are component-compatible:
8 multigrid vars (MultigridUserVariables.hpp:10-31) and the 29 GRChombo
evolution vars (GRChomboUserVariables.hpp:10-79).
"""

MULTIGRID_VARIABLE_NAMES = (
    "psi",
    "A11_0", "A12_0", "A13_0", "A22_0", "A23_0", "A33_0",
    "phi_0",
)
NUM_MULTIGRID_VARS = len(MULTIGRID_VARIABLE_NAMES)

GRCHOMBO_VARIABLE_NAMES = (
    "chi",
    "h11", "h12", "h13", "h22", "h23", "h33",
    "K",
    "A11", "A12", "A13", "A22", "A23", "A33",
    "Theta",
    "Gamma1", "Gamma2", "Gamma3",
    "lapse",
    "shift1", "shift2", "shift3",
    "B1", "B2", "B3",
    "phi", "Pi",
    "Ham",
    "Mom1", "Mom2", "Mom3",
)
NUM_GRCHOMBO_VARS = len(GRCHOMBO_VARIABLE_NAMES)

GRCHOMBO_INDEX = {name: i for i, name in enumerate(GRCHOMBO_VARIABLE_NAMES)}
