"""mg_ic_code_tpu_torch — the PyTorch/CUDA port of mg_ic_code_tpu.

Same capabilities, module for module, as the JAX package beside it: the
Hamiltonian constraint of GR in the conformally-flat Bowen-York approach,

    [alpha*aCoef(x)*I - beta*bCoef(x)*Laplacian] dpsi = rhs

re-linearised around psi in an outer Picard loop, each linear system solved
by BiCGStab preconditioned by AMR geometric-multigrid V-cycles with
red-black Gauss-Seidel smoothing.

Design stance of the port:
  * plain PyTorch functions on tensors, eager, no autograd (the solve runs
    under `torch.no_grad()`); static specs are frozen dataclasses
  * every entry point takes an explicit `device` (None = "cuda", and it
    raises when there is none; only device="cpu" runs on the CPU) and
    explicit dtypes
  * the hot smoother / residual / coarse-tower stencils are hand-written
    CUDA kernels for sm_90a under `csrc/`, compiled at first use; each
    has a plain PyTorch version beside its wrapper, which the wrapper
    takes only for CPU tensors
  * precision policy lives in `precision.py`: f64 outer Krylov, f32
    multigrid preconditioner, TF32 off
"""

from mg_ic_code_tpu_torch import precision  # noqa: F401  (sets TF32 off)
from mg_ic_code_tpu_torch.config import SolverConfig, ParamFile, load_params
from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import BCSpec, HierarchyGeom
from mg_ic_code_tpu_torch.precision import resolve_device

__version__ = "0.1.0"

__all__ = [
    "Box",
    "BCSpec",
    "HierarchyGeom",
    "ParamFile",
    "SolverConfig",
    "load_params",
    "resolve_device",
]
