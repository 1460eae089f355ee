"""User-specified scalar-field profile (reference: MyPhiFunction.H:11-22)."""

from __future__ import annotations

import math

import torch

from mg_ic_code_tpu_torch.config import SolverConfig


def phi_function(x, y, z, cfg: SolverConfig):
    """Gaussian phi = A * exp(-r^2 / lambda) — the reference's Dirichlet-mode
    profile (note the wavelength divides r^2 bare, matching the reference
    exactly)."""
    r2 = x * x + y * y + z * z
    return cfg.phi_amplitude * torch.exp(-r2 / cfg.phi_wavelength)


def phi_function_periodic(x, y, z, cfg: SolverConfig):
    """Triple-sine profile for periodic BCs (the commented-out variant of
    the reference), provided as a selectable alternative."""
    Lx, Ly, Lz = cfg.domain_length
    w = cfg.phi_wavelength
    two_pi = 2.0 * math.pi
    return cfg.phi_amplitude * (
        torch.sin(two_pi * x * w / Lx)
        + torch.sin(two_pi * y * w / Ly)
        + torch.sin(two_pi * z * w / Lz)
    )


def phi_profile(x, y, z, cfg: SolverConfig):
    """Profile selected by cfg.phi_profile."""
    if cfg.phi_profile == "sine":
        return phi_function_periodic(x, y, z, cfg)
    return phi_function(x, y, z, cfg)
