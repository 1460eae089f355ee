"""ctypes bindings for the native Berger-Rigoutsos grid builder.

The C++ library (native/br_mesh.cpp) supplies the roles the reference gets
from Chombo: BRMeshRefine tag clustering, domainSplit-style max-size
splitting and LoadBalance box->shard assignment (SetGrids.cpp:54-132). The
library is compiled on first use with the in-image g++; a pure-Python
fallback (same clustering strategy, bounding-box based) keeps the framework
functional if no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from mg_ic_code_tpu_torch.grid.boxes import Box

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libbr_mesh.so")

_lib = None
_lib_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(
            _LIB_PATH
        ) < os.path.getmtime(os.path.join(_NATIVE_DIR, "br_mesh.cpp")):
            subprocess.run(
                ["make", "-s", "-C", _NATIVE_DIR], check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_LIB_PATH)
        lib.br_cluster.restype = ctypes.c_int
        lib.br_cluster.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.morton_load_balance.restype = None
        lib.morton_load_balance.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def cluster_tags(
    tags: np.ndarray,
    fill_ratio: float,
    max_box_size: int,
    block_factor: int,
    lo_offset: tuple[int, int, int] = (0, 0, 0),
) -> list[Box]:
    """Cluster a boolean tag mask into boxes (Berger-Rigoutsos).

    `tags` is a (nx, ny, nz) array in the level's local frame; returned
    boxes are shifted by `lo_offset` into the level's global index space.
    """
    tags = np.ascontiguousarray(tags.astype(np.uint8))
    if not tags.any():
        return []
    lib = _load()
    if lib is None:
        boxes = _cluster_py(tags, fill_ratio, max_box_size, block_factor)
    else:
        max_out = 65536
        out = np.zeros((max_out, 6), dtype=np.int32)
        n = lib.br_cluster(
            tags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            tags.shape[0], tags.shape[1], tags.shape[2],
            float(fill_ratio), int(max_box_size), int(block_factor),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
        )
        if n < 0:
            raise RuntimeError("br_cluster: box capacity exceeded")
        boxes = [
            Box(tuple(int(v) for v in row[:3]), tuple(int(v) for v in row[3:]))
            for row in out[:n]
        ]
    return [b.shift(lo_offset) for b in boxes]


def load_balance(boxes: list[Box], n_ranks: int) -> list[int]:
    """Box -> shard assignment: Morton-ordered, volume-balanced."""
    if not boxes:
        return []
    lib = _load()
    arr = np.asarray(
        [[*b.lo, *b.hi] for b in boxes], dtype=np.int32
    ).reshape(-1, 6)
    if lib is None:
        return _load_balance_py(boxes, n_ranks)
    out = np.zeros(len(boxes), dtype=np.int32)
    lib.morton_load_balance(
        np.ascontiguousarray(arr).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int)
        ),
        len(boxes), int(n_ranks),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return [int(r) for r in out]


# ------------------------------------------------------- python fallbacks


def _cluster_py(tags, fill_ratio, max_box_size, block_factor) -> list[Box]:
    """Recursive bisection fallback: bounding box, split at the longest
    axis's signature minimum until the fill ratio is met."""

    def bound(mask_idx):
        lo = mask_idx.min(axis=0)
        hi = mask_idx.max(axis=0)
        return lo, hi

    out: list[Box] = []

    def recurse(sub: np.ndarray, off: np.ndarray, depth: int):
        idx = np.argwhere(sub)
        if idx.size == 0:
            return
        lo, hi = bound(idx)
        sub = sub[lo[0]: hi[0] + 1, lo[1]: hi[1] + 1, lo[2]: hi[2] + 1]
        off = off + lo
        fill = sub.mean()
        if fill >= fill_ratio or depth <= 0 or sub.size <= 8:
            out.append(Box(tuple(int(o) for o in off),
                           tuple(int(o + s - 1) for o, s in zip(off, sub.shape))))
            return
        d = int(np.argmax(sub.shape))
        axes = tuple(a for a in range(3) if a != d)
        sig = sub.sum(axis=axes)
        interior = sig[1:-1]
        cut = (int(np.argmin(interior)) + 1) if len(interior) else sub.shape[d] // 2
        sl_l = [slice(None)] * 3
        sl_r = [slice(None)] * 3
        sl_l[d] = slice(0, cut)
        sl_r[d] = slice(cut, None)
        off_r = off.copy()
        off_r[d] += cut
        recurse(sub[tuple(sl_l)], off.copy(), depth - 1)
        recurse(sub[tuple(sl_r)], off_r, depth - 1)

    recurse(tags.astype(bool), np.zeros(3, dtype=int), 64)

    # align + enforce max size
    domain = Box.from_shape(tags.shape)
    final: list[Box] = []
    for b in out:
        ab = b.align_to(block_factor).intersect(domain)
        if ab is None:
            continue
        final.extend(_split_max(ab, max_box_size))
    return sorted(set(final))


def _split_max(b: Box, max_size: int) -> list[Box]:
    chunks = [max(1, -(-s // max_size)) for s in b.shape]
    outs = []
    for ci in range(chunks[0]):
        for cj in range(chunks[1]):
            for ck in range(chunks[2]):
                lo, hi = [], []
                for d, c in zip(range(3), (ci, cj, ck)):
                    step = -(-b.shape[d] // chunks[d])
                    lo.append(b.lo[d] + c * step)
                    hi.append(min(b.lo[d] + (c + 1) * step - 1, b.hi[d]))
                if all(h >= l for l, h in zip(lo, hi)):
                    outs.append(Box(tuple(lo), tuple(hi)))
    return outs


def _morton_key(b: Box) -> int:
    c = [(l + h) // 2 for l, h in zip(b.lo, b.hi)]
    key = 0
    for bit in range(21):
        for d in range(3):
            key |= ((c[d] >> bit) & 1) << (3 * bit + d)
    return key


def _load_balance_py(boxes: list[Box], n_ranks: int) -> list[int]:
    order = sorted(range(len(boxes)), key=lambda i: _morton_key(boxes[i]))
    total = sum(b.num_cells for b in boxes)
    per = total / n_ranks
    assign = [0] * len(boxes)
    acc, rank = 0, 0
    for i in order:
        if acc > per * (rank + 1) and rank + 1 < n_ranks:
            rank += 1
        assign[i] = rank
        acc += boxes[i].num_cells
    return assign
