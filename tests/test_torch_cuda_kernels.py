"""On a CUDA device: the hand-written kernels against their plain PyTorch
versions, through the public wrappers. Skipped where there is no device.

This file imports only torch and the port, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest \
        -o addopts="" -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mg_ic_code_tpu_torch.grid.geometry import BCSpec, single_level_geom  # noqa: E402
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs  # noqa: E402
from mg_ic_code_tpu_torch.ops import kernel_counts  # noqa: E402
from mg_ic_code_tpu_torch.solver import multigrid as tmg  # noqa: E402

D, C, N = "dirichlet", "cf", "neumann"
KINDS = ((D, N), (C, D), (N, C))
DTYPES = {"f32": (np.float32, 2e-5), "f64": (np.float64, 1e-12)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")


def fields(shape, npdt, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "u": rng.standard_normal(shape).astype(npdt),
        "rhs": rng.standard_normal(shape).astype(npdt),
        "a": rng.uniform(0.5, 2.0, shape).astype(npdt),
        "b": rng.uniform(0.5, 2.0, shape).astype(npdt),
    }


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cuda_level_kernels_match_plain(dt):
    _need_cuda()
    npdt, rtol = DTYPES[dt]
    f = {k: torch.from_numpy(v).cuda()
         for k, v in fields((8, 12, 10), npdt).items()}
    kw = dict(kinds=KINDS, rho=2.0, alpha=1.0, beta=-1.0, dx=0.25)
    kernel_counts.reset()
    ref = tfs.gsrb_relax_plain(f["u"], f["rhs"], f["a"], f["b"], nsweeps=4,
                               lo=(2, 0, 1), **kw)
    out = tfs.gsrb_relax(f["u"], f["rhs"], f["a"], f["b"], nsweeps=4,
                         lo=(2, 0, 1), **kw)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())
    ref = tfs.residual_plain(f["u"], f["rhs"], f["a"], f["b"], **kw)
    out = tfs.residual(f["u"], f["rhs"], f["a"], f["b"], **kw)
    assert float((out - ref).abs().max()) <= rtol * float(ref.abs().max())
    assert kernel_counts.LAUNCHES["gsrb_relax"] == 1
    assert kernel_counts.LAUNCHES["residual"] == 1
    # one call = one launch per colour pass / one launch
    assert kernel_counts.DEVICE_LAUNCHES["gsrb_relax"] == 8
    assert kernel_counts.DEVICE_LAUNCHES["residual"] == 1
    # a CUDA tensor the kernel does not take raises; it never falls back
    with pytest.raises((TypeError, ValueError)):
        tfs.gsrb_relax(f["u"].half(), f["rhs"], f["a"], nsweeps=1,
                       lo=(0, 0, 0), **kw)


@pytest.mark.requires_cuda
def test_cuda_tower_vcycle_matches_cpu_plain():
    """mg_vcycle on the card (tower kernels) against the same V-cycle on
    the CPU (plain versions): f32, 5e-5 absolute on O(1) data."""
    _need_cuda()
    n = 32
    spec = tmg.make_level_spec(
        single_level_geom(n, 1.0, BCSpec(bc_lo=(1, 0, 1), bc_hi=(0, 1, 0))),
        0, alpha=1.0, beta=-1.0, nsmooth=4, smoother="auto")
    f = fields((n, n, n), np.float32, seed=7)
    outs = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.from_numpy(v).to(dev) for k, v in f.items()}
        sp = spec if dev == "cuda" else tmg.make_level_spec(
            single_level_geom(n, 1.0, BCSpec(bc_lo=(1, 0, 1),
                                             bc_hi=(0, 1, 0))),
            0, alpha=1.0, beta=-1.0, nsmooth=4, smoother="pallas")
        coefs = tmg.build_level_coefs(sp, t["a"])
        kernel_counts.reset()
        outs[dev] = tmg.mg_vcycle(sp, coefs, t["u"], t["rhs"]).cpu()
        counts = kernel_counts.snapshot()
        which = "launches" if dev == "cuda" else "plain_calls"
        assert counts[which]["tower_down"] == 1
        assert counts[which]["tower_up"] == 1
        if dev == "cuda":  # 32^3 -> 4^3: 4 depths, 4 smooths each
            assert counts["device_launches"]["tower_down"] == 4 * 8 + 3
            assert counts["device_launches"]["tower_up"] == 3 * 9
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=0, atol=5e-5)
