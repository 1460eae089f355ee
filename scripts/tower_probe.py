#!/usr/bin/env python3
"""Probe the coarse towers' device time on one card: what a grid barrier,
a smoothing sweep and the one-block tail cost (csrc/tower.cu).

    python3 scripts/tower_probe.py [--nsmooth 0,4] [--smem 53248,8192,1024,0]

For each shared-memory budget of the one-block tail (bytes in f32, twice
that in f64; at most the wrapper's own, coarse_tower.TOWER_SMEM; 0 leaves
every depth grid-wide) and each count of smoothing sweeps, every timed chain
of chip_smoke.TOWER_CASES: tower_down and tower_up in f32, the device's own
time per call (chip_smoke.device_ms, the batch enqueued behind a wait).
Then one grid barrier's time in a launch of one block and of the towers'
grid (the probe mgk_tower_barriers: 64 barriers against none). One JSON
line per measurement. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from mg_ic_code_tpu_torch.ops import coarse_tower as ct  # noqa: E402
from mg_ic_code_tpu_torch.ops import cuda_ext  # noqa: E402
from mg_ic_code_tpu_torch.ops import stencils as st  # noqa: E402


def chain_ms(case, nsmooth: int) -> dict:
    cid, shape, kinds, lo, _ = case
    spec = cs.chain_spec(shape, lo, kinds, dx0=0.11, nsmooth=nsmooth)
    f = cs.level_fields(shape, torch.float32, seed=2)
    a_list = [f["a"]]
    for _ in range(1, spec.ndepths):
        a_list.append(st.coarsen_coef(a_list[-1], "harmonic").contiguous())
    down = lambda: ct.tower_down(spec, 0, f["u"], f["rhs"], a_list)
    u_list, r_rest, u_bot = down()
    rhs_list = [f["rhs"]] + list(r_rest)
    up = lambda: ct.tower_up(spec, 0, 0.5 * u_bot, list(u_list),
                             rhs_list[:-1], a_list[:-1])
    blocks, tail, smem = ct.tower_geometry(
        [b.shape for b in spec.boxes], 4, ct.tower_capacity(f["u"].device, 4))
    return {"case": cid, "nsmooth": nsmooth, "blocks": blocks, "tail": tail,
            "smem": smem, "tower_down_ms": cs.device_ms(down),
            "tower_up_ms": cs.device_ms(up)}


def barrier_us(blocks: int) -> float:
    lib = cuda_ext.lib()

    def run(n):
        cuda_ext.check(lib.mgk_tower_barriers(
            blocks, n, torch.cuda.current_stream().cuda_stream),
            "tower barrier probe")

    return (cs.device_ms(lambda: run(64)) - cs.device_ms(lambda: run(0))) \
        / 64 * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nsmooth", default="0,4")
    ap.add_argument("--smem", default=str(ct.TOWER_SMEM[4]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tower_probe: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[:1]}))
    cases = [c for c in cs.TOWER_CASES if c[4]]
    # the kernels' shared-memory limit is set at the first capacity query:
    # the wrapper's budget, which the probed ones must not exceed
    capacity = ct.tower_capacity(torch.device("cuda", 0), 4)
    with torch.no_grad():
        for budget in (int(b) for b in args.smem.split(",")):
            ct.TOWER_SMEM.update({4: budget, 8: 2 * budget})
            ct._CHAINS.clear()
            for ns in (int(n) for n in args.nsmooth.split(",")):
                for case in cases:
                    print(json.dumps({"smem_budget": budget,
                                      **chain_ms(case, ns)}), flush=True)
        for blocks in (1, capacity):
            print(json.dumps({"barrier_blocks": blocks,
                              "barrier_us": barrier_us(blocks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
