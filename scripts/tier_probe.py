#!/usr/bin/env python3
"""Time the whole-level march's bf16 tier (smoother_precision = bfloat16)
against its f32 form, in one tree or several, on one card.

    python3 scripts/tier_probe.py OUT.json TREE [TREE ...]

Every TREE is a checkout (or a copy of `mg_ic_code_tpu_torch/` under a
directory), built into TREE/build/mgk_probe from its own sources: all trees
are built at once (one process each, nvcc's five units in parallel in
each), then timed one after the other on the same card, so that two forms
of the march compare within one call. Per case (the wave rung's open levels
960x144x144, 512x96x96, 272x80x80; the multisweep rung's periodic 256^3 and
512x96x96; 2 sweeps a launch, fields from seed 3 as chip_smoke.py makes
them): the device time of the tier and of the f32 form (the median over 15
batches of 20 calls enqueued behind torch.cuda._sleep, CUDA events), their
ratio, and a hash of the tier's output, by which two trees' outputs compare
bit for bit. Prints one line per tree and case; OUT.json holds the builds'
logs and every number.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

CASES = [  # (name, rung, shape, face kind of every face)
    ("wave_960x144x144", "wave", (960, 144, 144), "cf"),
    ("wave_512x96x96", "wave", (512, 96, 96), "cf"),
    ("wave_272x80x80", "wave", (272, 80, 80), "cf"),
    ("multi_256P", "multi", (256, 256, 256), "periodic"),
    ("multi_512x96x96P", "multi", (512, 96, 96), "periodic"),
]


def tree_env(tree: str) -> dict:
    env = dict(os.environ)
    env["MG_IC_BUILD_DIR"] = os.path.join(tree, "build", "mgk_probe")
    env["PYTHONPATH"] = tree
    return env


def device_ms(fn, reps: int = 15, batch: int = 20) -> float:
    import torch
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(10_000_000)  # the batch is enqueued behind it
        t0.record()
        for _ in range(batch):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / batch)
    times.sort()
    return times[len(times) // 2]


def time_tree() -> dict:
    """The cases in the tree on sys.path (run in a process of its own)."""
    import torch
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
    from mg_ic_code_tpu_torch.ops import wavefront as wf
    out = {}
    for name, rung, shape, kind in CASES:
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        u = torch.randn(shape, device="cuda", generator=g)
        rhs = torch.randn(shape, device="cuda", generator=g)
        a = 0.5 + 1.5 * torch.rand(shape, device="cuda", generator=g)
        kw = dict(kinds=((kind, kind),) * 3, rho=2.0, alpha=1.0, beta=-1.0,
                  dx=0.37, lo=(0, 0, 0), nsweeps=2)
        fn = wf.wavefront_relax if rung == "wave" else fs.multisweep_relax
        tier = lambda: fn(u, rhs, a, compute_dtype="bfloat16", **kw)  # noqa
        f32 = lambda: fn(u, rhs, a, **kw)  # noqa: E731
        digest = hashlib.sha256(tier().cpu().numpy().tobytes()).hexdigest()
        t, f = device_ms(tier), device_ms(f32)
        out[name] = {"tier_ms": t, "f32_ms": f, "ratio": t / f,
                     "hash": digest[:16]}
    return out


def main() -> int:
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_tree()))
        return 0
    out_path, trees = sys.argv[1], sys.argv[2:]
    t0 = time.time()
    build = ("from mg_ic_code_tpu_torch.ops import cuda_ext; "
             "cuda_ext.lib(); print(cuda_ext.BUILD_INFO['seconds'])")
    procs = [subprocess.Popen([sys.executable, "-c", build],
                              env=tree_env(t), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for t in trees]
    builds = {}
    for tree, proc in zip(trees, procs):
        log, _ = proc.communicate()
        builds[tree] = {"rc": proc.returncode, "log": log[-4000:]}
    res = {"build_s": time.time() - t0, "builds": builds, "times": {}}
    rc = 0
    for tree in trees:
        if builds[tree]["rc"] != 0:
            print(tree, "build failed:", builds[tree]["log"])
            rc = 1
            continue
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--time"], env=tree_env(tree),
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(tree, "failed:", run.stderr[-4000:])
            rc = 1
            continue
        res["times"][tree] = json.loads(run.stdout.strip().splitlines()[-1])
        print(tree)
        for case, r in res["times"][tree].items():
            print(f"  {case:20s} tier {r['tier_ms']:.4f} f32 "
                  f"{r['f32_ms']:.4f} x{r['ratio']:.3f} {r['hash']}")
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
