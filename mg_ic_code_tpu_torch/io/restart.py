"""Restart from a previously written GRChombo checkpoint.

The reference only WRITES checkpoints (for GRChombo to evolve) and notes
that a read-in-grids option "exists in principle" (SetGrids.cpp:29-30).
This module closes that loop: `load_state` reads a `vcPoissonFinal`-format
file written by io.chombo_hdf5 and reconstructs (geometry, psi) so a solve
can warm-start from a previous solution — e.g. re-solving with tightened
tolerance, more levels, or perturbed physics.

Inversion of the output transform (SetLevelData.cpp:343-396):
    chi = (psi_regular + psi_bh)^-4   =>   psi_regular = chi^-1/4 - psi_bh
"""

from __future__ import annotations

import numpy as np
import torch

from mg_ic_code_tpu_torch import precision
from mg_ic_code_tpu_torch.config import SolverConfig
from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom, geom_from_config
from mg_ic_code_tpu_torch.io import chombo_hdf5 as io
from mg_ic_code_tpu_torch.physics import bowen_york as by


def load_geometry(path: str, cfg: SolverConfig) -> HierarchyGeom:
    """Rebuild the hierarchy recorded in a checkpoint. Multi-box levels
    (the forest's sibling patches, or any Chombo union-of-boxes file whose
    boxes are mutually separated) become sibling entries whose parent is
    the depth-(d-1) box containing them."""
    io._require_h5py()
    import h5py

    with h5py.File(path, "r") as f:
        nl = int(f.attrs["num_levels"])
    boxes: list = []
    parent: list[int] = []
    prev_entries: list[int] = []
    for d in range(nl):
        # the reader returns valid (ungrown) boxes regardless of the
        # file's outputGhost convention
        lvl_boxes, _, _, _ = io.read_level_patches(path, d)
        cur: list[int] = []
        for b in lvl_boxes:
            if d == 0:
                p = -1
            else:
                p = next(
                    (e for e in prev_entries
                     if boxes[e].refine(cfg.ref_ratio).contains_box(b)),
                    None,
                )
                if p is None:
                    raise ValueError(
                        f"checkpoint level {d} box {b} is not nested in "
                        f"any single level-{d - 1} box — a union-of-boxes "
                        f"layout whose boxes straddle parents cannot load "
                        f"as a patch forest; coarsen the box layout or "
                        f"restart in bbox mode"
                    )
            cur.append(len(boxes))
            boxes.append(b)
            parent.append(p)
        prev_entries = cur
    return geom_from_config(cfg, tuple(boxes), tuple(parent))


def load_state(path: str, cfg: SolverConfig, dtype=precision.OUTER_DTYPE,
               device=None):
    """(geom, psi_list, constant_K) from a GRChombo-format checkpoint; psi
    as tensors on `device` (None = the CUDA device, "cpu" for the CPU)."""
    device = precision.resolve_device(device)
    geom = load_geometry(path, cfg)
    psi: list = [None] * geom.num_levels
    constant_K = 0.0
    for d in range(geom.max_depth + 1):
        lvl_boxes, _, _, patches = io.read_level_patches(path, d)
        ents = geom.entries_at_depth(d)
        assert len(ents) == len(lvl_boxes)
        for e, box, named in zip(ents, lvl_boxes, patches):
            assert geom.boxes[e] == box
            chi = named["chi"]  # valid region (ghost rind stripped)
            x, y, z = (torch.as_tensor(c, dtype=dtype, device=device)
                       for c in geom.coords(e))
            psi_bh = torch.broadcast_to(by.psi_bh(x, y, z, cfg), chi.shape)
            chi_t = torch.as_tensor(
                np.ascontiguousarray(chi), dtype=dtype, device=device)
            psi[e] = chi_t ** (-0.25) - psi_bh
            constant_K = float(named["K"][1, 1, 1])
    return geom, psi, constant_K
