"""Carry state across from plain host data into the port's structures.

Every function takes numpy arrays and plain tuples/dicts — what any other
implementation of the same solver can export with `np.asarray` — and
returns the port's counterpart: a `HierarchyGeom`, lists of level tensors,
the per-level static fields, the per-level coefficient dicts. Tests use
them so that two implementations compute from identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import BCSpec, HierarchyGeom
from mg_ic_code_tpu_torch.precision import resolve_device


def _box(b) -> Box:
    """((lo), (hi)) -> Box (a Box passes through)."""
    if isinstance(b, Box):
        return b
    lo, hi = b
    return Box(tuple(int(v) for v in lo), tuple(int(v) for v in hi))


def geom_from_plain(
    boxes, parent, dx, bc, domain_boxes, domain_length, ref_ratio: int = 2,
) -> HierarchyGeom:
    """Build the port's HierarchyGeom from plain data: `boxes` and
    `domain_boxes` as ((lo), (hi)) pairs per entry, `parent` a tuple of
    entry indices (or None for the chain), `dx` per entry, `bc` a dict with
    keys bc_lo, bc_hi, bc_value, periodic."""
    return HierarchyGeom(
        boxes=tuple(_box(b) for b in boxes),
        domain_boxes=tuple(_box(b) for b in domain_boxes),
        dx=tuple(float(d) for d in dx),
        domain_length=tuple(float(v) for v in domain_length),
        bc=BCSpec(
            bc_lo=tuple(int(v) for v in bc["bc_lo"]),
            bc_hi=tuple(int(v) for v in bc["bc_hi"]),
            bc_value=float(bc["bc_value"]),
            periodic=bool(bc["periodic"]),
        ),
        ref_ratio=int(ref_ratio),
        parent=None if parent is None else tuple(int(p) for p in parent),
    )


def tensor_from_numpy(arr, device=None, dtype=None) -> torch.Tensor:
    """One numpy array -> a contiguous tensor on `device` (None = cuda);
    `dtype` None keeps the array's own."""
    device = resolve_device(device)
    # a fresh C-ordered copy: exported arrays are often read-only views
    t = torch.from_numpy(np.array(arr, order="C", copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def level_list_from_numpy(arrs, device=None, dtype=None) -> list:
    """Per-level numpy arrays -> list of tensors (None entries stay None)."""
    return [
        None if a is None else tensor_from_numpy(a, device, dtype)
        for a in arrs
    ]


def fields_from_numpy(fields, device=None, dtype=None) -> list:
    """Per-level static problem fields (dicts with phi, rho_grad, aij2,
    psi_bh and the nested aij component dict) -> the port's field dicts."""
    out = []
    for f in fields:
        d = {}
        for k, v in f.items():
            if isinstance(v, dict):
                d[k] = {kk: tensor_from_numpy(vv, device, dtype)
                        for kk, vv in v.items()}
            else:
                d[k] = tensor_from_numpy(v, device, dtype)
        out.append(d)
    return out


def _chain(t, device, dtype):
    return tuple(level_list_from_numpy(t, device, dtype))


def coefs_from_numpy(coefs, device=None) -> tuple:
    """The tuple of per-level coefficient dicts {"a", "b", "lam"[, "binv"]}
    (each a depth chain of arrays; "b" entries may be None), with their
    reduced-precision copy under "lp" when present, -> the port's. Dtypes
    are kept as given (f64 chains, f32 under "lp")."""
    out = []
    for c in coefs:
        d = {k: _chain(c[k], device, None) for k in ("a", "b", "lam")}
        if c.get("binv") is not None:
            d["binv"] = tensor_from_numpy(c["binv"], device)
        if "lp" in c:
            lp = {k: _chain(c["lp"][k], device, None)
                  for k in ("a", "b", "lam")}
            if c["lp"].get("binv") is not None:
                lp["binv"] = tensor_from_numpy(c["lp"]["binv"], device)
            d["lp"] = lp
        out.append(d)
    return tuple(out)


def solve_state_from_plain(state: dict, device=None, dtype=None) -> dict:
    """A solve state exported by another implementation — a dict with the
    geometry's plain description under "geom" (the keyword arguments of
    `geom_from_plain`), per-level arrays "psi", "dpsi" and optionally "rhs",
    the per-level static "fields" (with the nested "aij" component dict)
    and the scalar "constant_K" — carried into the port's structures: what
    the port's writers (io/chombo_hdf5) and its restart take."""
    out = {
        "geom": geom_from_plain(**state["geom"]),
        "fields": fields_from_numpy(state["fields"], device, dtype),
        "constant_K": float(state.get("constant_K", 0.0)),
    }
    for key in ("psi", "dpsi", "rhs"):
        if key in state:
            out[key] = level_list_from_numpy(state[key], device, dtype)
    return out


def mesh_from_jax(jax_mesh, devices):
    """The port's Mesh with the axis names and shape of another
    implementation's device mesh (anything with `axis_names` and a
    `devices` array, read without importing its library). `devices` are the
    port's devices for it: one per mesh position in row-major order, or a
    single device that then fills every position (one card, or the CPU,
    standing in for all of them)."""
    from mg_ic_code_tpu_torch.parallel.mesh import Mesh

    sizes = tuple(int(s) for s in np.shape(jax_mesh.devices))
    n = int(np.prod(sizes))
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"mesh of {n} positions, {len(devices)} devices")
    return Mesh(devices, tuple(jax_mesh.axis_names), sizes)
