"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled by `nvcc` for sm_90a at FIRST USE — never at
import — into a shared library with a plain C interface and loaded with
ctypes (no PyTorch headers in the build: it takes seconds). One `nvcc -c`
per source, all started together, then one link. The library lands in
`build/mg_ic_code_tpu_torch/` beside the package (override with the
MG_IC_BUILD_DIR environment variable), keyed by a hash of the sources and
flags, so an unchanged tree reuses it.

There is no fallback: without `nvcc`, or when a source does not compile,
`lib()` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("gsrb_relax.cu", "residual.cu", "tower.cu")
HEADERS = ("mg_kernels.h", "residual_device.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# what the last lib() call did: {"seconds", "cached", "library", "log"}
BUILD_INFO: dict = {}

_lib = None


def build_dir() -> str:
    return os.environ.get("MG_IC_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "mg_ic_code_tpu_torch"
    )


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(out_path: str, bdir: str) -> str:
    """Compile every source in parallel, link, return the compiler log."""
    nvcc = _nvcc()
    tag = os.path.basename(out_path)[:-3]
    procs = []
    for src in SOURCES:
        obj = os.path.join(bdir, f"{tag}_{src[:-3]}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c",
               os.path.join(CSRC_DIR, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== nvcc {src} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(log)
        )
    tmp = out_path + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    log.append(f"== link (exit {link.returncode})\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    os.replace(tmp, out_path)
    for _, obj, _ in procs:
        os.remove(obj)
    return "\n".join(log)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pi, pd, pvp = (ctypes.POINTER(ci), ctypes.POINTER(cd),
                   ctypes.POINTER(vp))
    lib.mgk_gsrb_relax.restype = ci
    lib.mgk_gsrb_relax.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, pi, cd, cd, cd, cd, ci, ci, vp,
    ]
    lib.mgk_residual.restype = ci
    lib.mgk_residual.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, pi, cd, cd, cd, cd, vp,
    ]
    lib.mgk_tower_down.restype = ci
    lib.mgk_tower_down.argtypes = [
        pvp, pvp, pvp, ci, ci, pi, pi, pd, pd, pi, cd, cd, ci, vp,
    ]
    lib.mgk_tower_up.restype = ci
    lib.mgk_tower_up.argtypes = [
        vp, pvp, pvp, pvp, ci, ci, pi, pi, pd, pd, pi, cd, cd, ci, vp,
    ]


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    bdir = build_dir()
    os.makedirs(bdir, exist_ok=True)
    path = os.path.join(bdir, f"libmgk_{_source_hash()}.so")
    log_path = path[:-3] + ".log"
    cached = os.path.exists(path)
    if not cached:
        log = _build(path, bdir)
        with open(log_path, "w") as f:
            f.write(log)
    loaded = ctypes.CDLL(path)
    _declare(loaded)
    _lib = loaded
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, cached=cached, library=path,
        log=log_path,
    )
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA launch error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
