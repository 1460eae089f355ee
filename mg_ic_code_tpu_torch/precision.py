"""Device and precision policy of the port — the one place both are set.

Precision
  * The outer Krylov arithmetic (BiCGStab over the composite vector, the
    Picard update and every norm) is float64: the reference is double
    throughout and the 1e-10 tolerances demand it.
  * The multigrid preconditioner runs in float32 when `precond_precision`
    is `single`, or `auto` on a CUDA device (the counterpart of the JAX
    package resolving `auto` to single on its accelerator): the hand-written
    f32 kernels are the production path. `double`, or `auto` on the CPU,
    keeps the preconditioner at the operand precision.
  * TF32 is off for matmuls and cuDNN: the dense bottom inverse product
    must stay a true f32 product (a reduced-mantissa product inside every
    V-cycle degrades the Picard plateau).

Device
  * Entry points take `device`. None means "cuda" and raises when no CUDA
    device is present; only an explicit device="cpu" runs on the CPU.
"""

from __future__ import annotations

import torch

OUTER_DTYPE = torch.float64
PRECOND_DTYPE = torch.float32

# stated and set: f32 matmuls stay full f32 everywhere in the port
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. None -> the CUDA device (raises
    without one); anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU unless "
                "device='cpu' is passed explicitly"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but none is available")
    return device


def precond_dtype(precond_precision: str, device: torch.device) -> str | None:
    """'float32' when the preconditioner runs in reduced precision, else
    None (operand precision) — see the module docstring."""
    if precond_precision == "single":
        return "float32"
    if precond_precision == "auto" and torch.device(device).type == "cuda":
        return "float32"
    return None
